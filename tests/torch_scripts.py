"""``chip_smoke.py`` as a module, loaded once per process, for the port's
tests that share its checks and records: ``from torch_scripts import
chip_smoke``. Its ``load_script`` loads the examples and benchmarks."""
import importlib.util
import pathlib


def _load():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load()
