"""``python -m iscc_search_tpu_torch.cli``: the CLI's entry point."""

import sys

from iscc_search_tpu_torch.cli import main

if __name__ == "__main__":  # guarded: importing this module runs nothing
    sys.exit(main())
