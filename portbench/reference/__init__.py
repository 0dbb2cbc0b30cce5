"""The plain references of the configurations: ``answers``, ``judge``, ``control_answers``.

Written from the definitions in plain PyTorch and NumPy; they import nothing
of the program.
"""
