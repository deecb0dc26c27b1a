"""Traffic drivers, found by name: ``bench/drivers/<driver>.py``'s
``Driver(ctx)`` with ``setup()``, ``window(seconds)``, ``collect()``,
``close()`` and ``check()``."""
