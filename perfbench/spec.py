"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` of ``workloads`` is ``workloads/<name>.json`` (its
traffic mix and the limits of its check), its configuration is
``configs/<config>.json`` with the generator it names,
``generators/<generator>.py``, and each per-layer metric is a reader
``metrics/<metric>.py`` with a function ``read(record)``. Adding a cell,
a configuration or a metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything the run needs of it:
    ``entry`` (the BENCHMARK.json entry), ``traffic`` (the workload
    file), ``config`` (the configuration file), ``end_to_end`` and
    ``per_layer`` (the metrics this cell reports), ``generator`` and
    ``readers`` (the modules found by name)."""

    def __init__(self, name: str, root: Path = HERE.parent,
                 bench_dir: Path = HERE):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        config_entry = configs[self.entry["config"]]
        self.config = json.loads((self.root / config_entry["file"])
                                 .read_text())
        self.traffic = json.loads(
            (self.bench_dir / "workloads" / f"{name}.json").read_text())
        if self.traffic["config"] != self.entry["config"]:
            raise ValueError(f"{name}: the workload file names "
                             f"{self.traffic['config']!r}, BENCHMARK.json "
                             f"{self.entry['config']!r}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.generator = load_module(
            self.bench_dir / "generators" / f"{self.config['generator']}.py",
            f"perfbench_generator_{self.config['generator']}")
        self._readers = None

    def readers(self) -> dict:
        """metric name -> its ``read(record)``, for this cell's per-layer
        metrics (imported at first use)."""
        if self._readers is None:
            self._readers = {
                m["name"]: load_module(
                    self.bench_dir / "metrics" / f"{m['name']}.py",
                    "perfbench_metric_" + m["name"].replace(".", "_")).read
                for m in self.per_layer}
        return self._readers
