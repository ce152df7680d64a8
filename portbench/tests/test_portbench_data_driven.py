"""A configuration, a traffic mix, a loop kind's parameters and a metric
are added as new files alone; the harness finds each by name."""

import hashlib
import json
import os

from portbench import harness, spec
from portbench.tests.conftest import DATA, copy_benchmark

METRIC = '''"""A throwaway per-layer metric: answers a second in the window."""


def read(run):
    return run.answered_in_window / run.seconds
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = copy_benchmark(str(tmp_path))
    before = _digests(os.path.join(root, "portbench"))
    b = os.path.join(root, "portbench")
    with open(os.path.join(b, "configs", "extra_cfg.json"), "w") as f:
        json.dump(dict(model=os.path.join(DATA, "fsrcnn_x2_small_int8.tflite"),
                       numerics="exact", max_batch=4, reduced=[],
                       source="https://arxiv.org/abs/1608.00367"), f)
    with open(os.path.join(b, "traffic", "extra_mix.json"), "w") as f:
        json.dump(dict(loop="poisson", rate=40.0, arrival_seed=3, pool=4), f)
    with open(os.path.join(b, "metrics", "extra_metric.py"), "w") as f:
        f.write(METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name="extra_cfg.extra_mix",
                                   config="extra_cfg", traffic="extra_mix",
                                   chips=1, why="a test's cell"))
    bench["per_layer"].append(dict(
        name="extra_metric", unit="req/s", better="higher",
        source="host_clock", layer="load generator", moves="setup_s",
        workloads=["extra_cfg.extra_mix"]))
    with open(path, "w") as f:
        json.dump(bench, f)

    assert "extra_cfg" in spec.list_configs(root)
    assert "extra_mix" in spec.list_traffic(root)
    assert "extra_metric" in spec.list_metrics(root)
    assert {"closed", "periodic", "poisson"} <= set(spec.list_loops(root))
    cell = spec.cell(root, "extra_cfg.extra_mix")
    assert cell["config"]["max_batch"] == 4
    assert cell["traffic"]["loop"] == "poisson"
    assert [m["name"] for m in cell["per_layer"]] == ["extra_metric"]
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s"]

    result = harness.run_cell(root, "extra_cfg.extra_mix", 12, 1.0, True,
                              "cpu", 0.0)
    assert result["correct"], result["checks"]
    assert result["metrics"]["extra_metric"]["value"] > 0
    result = harness.run_cell(root, "extra_cfg.extra_mix", 13, 1.0, False,
                              "cpu", 0.0)
    assert list(result["metrics"]) == ["setup_s"]
    # nothing that was there changed
    after = _digests(os.path.join(root, "portbench"))
    changed = [k for k in before if after.get(k) != before[k]
               and "__pycache__" not in k]
    assert changed == []


def test_a_metric_file_of_its_own_comes_first(tmp_path):
    root = copy_benchmark(str(tmp_path))
    own = os.path.join(root, "portbench", "metrics", "idle_share.video.py")
    with open(own, "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    assert spec.reader(root, "idle_share.video")(None) == 42.0
    assert spec.reader(root, "idle_share.stream") is not spec.reader(
        root, "idle_share.video")
