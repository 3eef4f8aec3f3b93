"""Finding a cell's files by name.

:class:`Bench` reads ``BENCHMARK.json`` at ``root`` and the benchmark's
files under ``bench_dir`` (the checkout's ``benchmark/`` by default): a
later cell, configuration, traffic mix or metric is a file added there,
and nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"benchmark._found.{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root: Path | str = ROOT, bench_dir: Path | str | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def json(self, *parts) -> dict:
        return json.loads(self.dir.joinpath(*parts).read_text())

    def cell(self, name: str) -> dict:
        """The cell's entry, with its configuration entry under ``config``
        and the files it names loaded: ``model`` (the configuration file),
        ``traffic`` and ``limits``."""
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = dict(cells[name])
        cfg = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        w["config_entry"] = cfg
        w["model"] = json.loads((self.root / cfg["file"]).read_text())
        w["traffic_params"] = self.json("traffic", w["traffic"] + ".json")
        w["limits"] = self.json("workloads", name + ".json")["limits"]
        return w

    def metrics_of(self, name: str, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        cell_e2e = {m["name"] for m in self.spec["end_to_end"]
                    if "workloads" not in m or name in m["workloads"]}
        if section == "end_to_end":
            return [m for m in self.spec["end_to_end"] if m["name"] in cell_e2e]
        return [m for m in self.spec["per_layer"]
                if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in cell_e2e))]

    def reader(self, section: str, metric: str):
        """``read(run)`` of a metric: ``e2e/<name>.py`` or
        ``metrics/<name>.py``, else the reader of the quantity before the
        first dot (``idle_pct.ens`` -> ``metrics/idle_pct.py``)."""
        folder = self.dir / ("e2e" if section == "end_to_end" else "metrics")
        for stem in (metric, metric.split(".")[0]):
            path = folder / f"{stem}.py"
            if path.exists():
                return _module(path, f"{folder.name}.{stem}").read
        raise FileNotFoundError(f"no reader for {metric} under {folder}")

    def load(self, kind: str):
        return _module(self.dir / "loads" / f"{kind}.py", f"loads.{kind}")

    def flops(self, model_kind: str):
        return _module(self.dir / "flops" / f"{model_kind}.py", f"flops.{model_kind}")

    def conv_kernel_patterns(self) -> list[str]:
        """Every name fragment that marks a device kernel as a 3x3 conv."""
        out = []
        for path in sorted((self.dir / "kernels").glob("*.json")):
            fam = json.loads(path.read_text())
            if fam.get("counted_as") == "conv3x3":
                out += fam["name_contains"]
        return out

    def peaks(self, device_kind: str) -> dict | None:
        return self.json("peaks.json").get(device_kind)
