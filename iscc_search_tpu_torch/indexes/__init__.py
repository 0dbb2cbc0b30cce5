"""Index backends over the port's engines (``indexes/tpu``)."""
