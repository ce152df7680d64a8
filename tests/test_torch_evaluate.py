"""The port's accuracy gate (band_tpu_torch/tools/evaluate.py) on CPU
workers against the TFLite interpreter: exact agreement on random inputs
(the port follows TFLite on MEAN, ROADMAP C1), top-1/top-5 agreement on
images cut from generated camera frames, the SSD detection spot check,
and the default config, which names the card and refuses to run without
one instead of falling back to the host."""

import json
import os

import pytest

pytest.importorskip("tensorflow")

import band_tpu_torch as tb
from band_tpu_torch.tools import evaluate as tev

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cpu(host_only_ops=False):
    b = (tb.RuntimeConfigBuilder()
         .add_scheduler(tb.SchedulerType.SHORTEST_EXPECTED_LATENCY
                        if host_only_ops else tb.SchedulerType.FIXED_WORKER)
         .add_worker(tb.WorkerSpec(device=tb.DeviceFlag.CPU,
                                   device_ids=(0,)))
         .profile_warmups(0).profile_runs(1))
    return b.build()


@pytest.mark.parametrize("name", ["effnetlite_int8", "fc_int8"])
def test_evaluate_exact_against_tflite(name):
    report = tev.evaluate(os.path.join(DATA, f"{name}.tflite"), n_samples=2,
                          config=_cpu())
    assert report["numerics"] == "exact" and report["samples"] == 2
    for st in report["outputs"].values():
        assert st["max_diff"] == 0
        assert st["exact_frac"] == 1.0
    assert report["top1_agreement"] == 1.0


def test_top1_on_generated_frames():
    report = tev.evaluate_topk_images(
        os.path.join(DATA, "effnetlite_int8.tflite"), n_images=4,
        config=_cpu())
    assert report["images"] == 4
    assert report["top1_agreement"] == 1.0
    assert report["top5_agreement"] == 1.0
    assert report["max_quant_unit_diff"] == 0


def test_image_set_is_cut_from_generated_frames():
    a = tev._image_set(3, 32, 24, "int8")
    b = tev._image_set(3, 32, 24, "int8")
    assert [x.shape for x in a] == [(1, 24, 32, 3)] * 3
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == a[1]).all()


def test_detection_spot_check():
    report = tev.evaluate_detection(os.path.join(DATA, "ssd_int8.tflite"),
                                    n_samples=2, config=_cpu(True))
    assert report["map_spot_check"] == 1.0
    assert report["max_score_diff"] < 1e-6
    assert report["max_box_coord_diff"] < 1e-5


def test_default_config_names_the_card():
    cfg = tev.default_config()
    assert [w.device for w in cfg.worker.workers] == [tb.DeviceFlag.GPU]
    host = tev.default_config(host_worker=True)
    assert [w.device for w in host.worker.workers] == [tb.DeviceFlag.GPU,
                                                       tb.DeviceFlag.CPU]
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(tb.ConfigError, match="CUDA"):
            tev.evaluate(os.path.join(DATA, "fc_int8.tflite"), n_samples=1)


def test_cli(tmp_path, capsys):
    cfg = tmp_path / "cpu.json"
    cfg.write_text(json.dumps({
        "schedulers": ["fixed_worker"],
        "workers": [{"device": "cpu", "device_ids": [0]}],
        "profile_num_warmups": 0, "profile_num_runs": 1}))
    assert tev.main(["--config", str(cfg),
                     os.path.join(DATA, "fc_int8.tflite"), "1"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["model"] == "fc_int8.tflite" and report["samples"] == 1
    assert tev.main([]) == 2
    assert tev.main(["--config"]) == 2
