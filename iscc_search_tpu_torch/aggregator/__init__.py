"""
The IDP aggregator's network table (copy of the ``NETWORKS`` constant of
``iscc_search_tpu/aggregator/__init__.py``): the options read it to check
``aggregator_network`` and name the aggregator index. The poller, the
transparency-log client and the entry conversion are not ported
(ROADMAP.md, queue 1); aggregator mode raises in ``server.httpd.serve``.
"""

# Network-keyed knowledge shared by options (index name, allowed networks) and
# entry conversion (realm check).
NETWORKS = {
    "testnet": {"realm": 0, "index": "idptest"},
    "mainnet": {"realm": 1, "index": "idp"},
}
