"""Routes: how a cell drives the program. A traffic file names one; each
module here defines ``Route(cell, seed, device, faults)`` with ``setup()``,
``window(seconds)``, ``traced()``, ``release()``, ``check()`` and
``close()`` (see ``perfbench/harness.py``)."""
