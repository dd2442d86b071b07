"""For the benchmark's CPU tests: the tiny stand-in of each configuration
that `tests/conftest.py`'s `TINY` (the map its `make_root` reads to turn
every cell a metric of BENCHMARK.json lists into its tiny cell) does not
name yet, added to that map once the test session has loaded it."""
from pathlib import Path

TINY = {"kanana-2-30b-a3b": "kanana-tiny"}

TESTS_CONFTEST = Path(__file__).resolve().parent / "tests" / "conftest.py"


def pytest_configure(config):
    for plugin in config.pluginmanager.get_plugins():
        if getattr(plugin, "__file__", None) and \
                Path(plugin.__file__).resolve() == TESTS_CONFTEST:
            for name, tiny in TINY.items():
                plugin.TINY.setdefault(name, tiny)
