"""The benchmark's own tests: ``python -m pytest kgbench/tests -q`` from the
repository root. Tests marked ``gpu`` need a CUDA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped without one")
