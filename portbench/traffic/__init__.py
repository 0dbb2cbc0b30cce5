"""Traffic: each mix ``<mix>.json`` names its generator, a module here
(``"generator": "closed_loop"``) whose ``run(handle, requests, mix, seconds,
record, rounds)`` drives the requests and returns a
:class:`~portbench.traffic.closed_loop.Outcome`."""
