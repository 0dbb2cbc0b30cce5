"""The systems under test, one module per kind of configuration.

A configuration's file names its kind (``"system"``). The module makes the
data and the request pool from the seed (``make_data(config, seed,
device)``, ``make_pool(data, config, mix, seed)``), builds the program from
the data and answers requests through the program's public calls
(``System(data, config, mix, device, spans)`` with ``first_search``,
``warm_shapes``, ``handle``, ``close``), and gives the shapes that the work
of one sweep is counted from (``sweep_shapes(data, config, mix)``, for
``work.sweep_work``).
"""
