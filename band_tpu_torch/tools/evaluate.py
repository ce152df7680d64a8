"""Accuracy gate: agreement between the port's engine and the TFLite
interpreter.

A port of band_tpu/tools/evaluate.py.  Each function serves the model
through ``Engine`` on the workers its ``config`` names (by default one
GPU worker; an engine with a GPU worker fails to start without a card)
and runs the TFLite interpreter with builtin kernels on the same
tensors.  It reports per-output max |diff| in quantized units, the
exact-match fraction and top-1 agreement for classification-shaped
outputs.  TensorFlow is imported only inside these functions.

Usage: python -m band_tpu_torch.tools.evaluate [--fast] [--config cfg.json]
           model.tflite [n_samples]
       ... --top1 model.tflite [n_images]
       ... --detection model.tflite [n_samples]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np

from ..common import DeviceFlag, SchedulerType
from ..config import RuntimeConfig, RuntimeConfigBuilder, WorkerSpec
from ..config import config_from_json
from ..ir.model import Model
from ..runtime.engine import Engine


def default_config(host_worker: bool = False) -> RuntimeConfig:
    """One GPU worker (and, for models with host-only ops, a host
    worker beside it)."""
    b = (
        RuntimeConfigBuilder()
        .add_scheduler(SchedulerType.SHORTEST_EXPECTED_LATENCY
                       if host_worker else SchedulerType.FIXED_WORKER)
        .add_worker(WorkerSpec(device=DeviceFlag.GPU, device_ids=(0,)))
        .profile_warmups(0)
        .profile_runs(1)
    )
    if host_worker:
        b.add_worker(WorkerSpec(device=DeviceFlag.CPU, device_ids=(0,)))
        b.minimum_subgraph_size(1)
    return b.build()


def _interpreter(path: str):
    import tensorflow as tf

    it = tf.lite.Interpreter(
        model_path=path,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES
        ),
    )
    it.allocate_tensors()
    return it


class _Served:
    """One engine serving one model; outputs keyed by tensor index."""

    def __init__(self, path: str, config: Optional[RuntimeConfig],
                 exact: bool, host_worker: bool = False):
        self.engine = Engine.create(config or default_config(host_worker))
        try:
            self.model_id = self.engine.register_model(
                Model.from_path(path),
                numerics="exact" if exact else "fast")
        except BaseException:
            self.engine.shutdown()
            raise
        g = self.engine.model_record(self.model_id).model.graph
        self.inputs: List[int] = list(g.inputs)
        self.outputs: List[int] = list(g.outputs)

    def run(self, feeds: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        outs = self.engine.request_sync(
            self.model_id, [feeds[t] for t in self.inputs], timeout=300)
        return dict(zip(self.outputs, outs))

    def close(self) -> None:
        self.engine.shutdown()


def evaluate(path: str, n_samples: int = 8, exact: bool = True,
             config: Optional[RuntimeConfig] = None) -> Dict:
    """Random inputs (seed 0) through both engines."""
    it = _interpreter(path)
    served = _Served(path, config, exact)
    try:
        rng = np.random.default_rng(0)
        stats: Dict[str, Dict] = {}
        top1_agree = 0
        top1_total = 0
        for _ in range(n_samples):
            feeds = {}
            for d in it.get_input_details():
                shape, dt = d["shape"], d["dtype"]
                if np.issubdtype(dt, np.integer):
                    info = np.iinfo(dt)
                    feeds[d["index"]] = rng.integers(
                        info.min, info.max + 1, shape
                    ).astype(dt)
                else:
                    feeds[d["index"]] = rng.standard_normal(shape).astype(dt)
            for idx, arr in feeds.items():
                it.set_tensor(idx, arr)
            it.invoke()
            ours = served.run(feeds)
            for d in it.get_output_details():
                ref = it.get_tensor(d["index"])
                o = ours[d["index"]]
                key = d["name"] or str(d["index"])
                st = stats.setdefault(
                    key, {"max_diff": 0.0, "exact_frac": [],
                          "dtype": str(ref.dtype)}
                )
                if np.issubdtype(ref.dtype, np.integer):
                    diff = np.abs(o.astype(np.int64) - ref.astype(np.int64))
                    st["max_diff"] = max(st["max_diff"], int(diff.max()))
                    st["exact_frac"].append(float((diff == 0).mean()))
                else:
                    diff = np.abs(o - ref)
                    st["max_diff"] = max(st["max_diff"], float(diff.max()))
                    st["exact_frac"].append(float((diff < 1e-5).mean()))
                if ref.ndim == 2 and ref.shape[0] == 1 and ref.shape[1] >= 10:
                    top1_total += 1
                    if int(np.argmax(o)) == int(np.argmax(ref)):
                        top1_agree += 1
    finally:
        served.close()
    for st in stats.values():
        st["exact_frac"] = float(np.mean(st["exact_frac"]))
    report = {
        "model": path.rsplit("/", 1)[-1],
        "samples": n_samples,
        "numerics": "exact" if exact else "fast",
        "outputs": stats,
    }
    if top1_total:
        report["top1_agreement"] = top1_agree / top1_total
    return report


SOURCE_SEEDS = (1234, 1235)  # the generated scenes the image set is cut from
SOURCE_SIZE = (640, 480)


def _image_set(n_images: int, width: int, height: int, dtype):
    """Derive an image evaluation set from generated camera frames
    (buffer/synthetic.py) via the preprocessing pipeline: random crops,
    flips, right-angle rotations and rescales.  The oracle and the port
    consume identical tensors, so agreement isolates the inference
    engines, while generation exercises the data plane."""
    from ..buffer.buffer import Buffer
    from ..buffer.processor import ImageProcessorBuilder
    from ..buffer.synthetic import camera_frame

    sources = [camera_frame(s, *SOURCE_SIZE).array() for s in SOURCE_SEEDS]
    rng = np.random.default_rng(1234)
    out = []
    for i in range(n_images):
        src = sources[i % len(sources)]
        h, w = src.shape[:2]
        b = ImageProcessorBuilder()
        # random crop keeping >= 60% of each side
        cw = int(w * rng.uniform(0.6, 1.0))
        ch = int(h * rng.uniform(0.6, 1.0))
        x0 = int(rng.integers(0, w - cw + 1))
        y0 = int(rng.integers(0, h - ch + 1))
        b.add_crop(x0, y0, x0 + cw - 1, y0 + ch - 1)
        if rng.random() < 0.5:
            b.add_flip(horizontal=True)
        rot = int(rng.integers(0, 4)) * 90
        if rot:
            b.add_rotate(rot)
        b.add_auto_convert((1, height, width, 3), dtype)
        out.append(b.build().to_tensor(Buffer.from_numpy(src)))
    return out


def evaluate_topk_images(path: str, n_images: int = 100, exact: bool = True,
                         config: Optional[RuntimeConfig] = None) -> Dict:
    """Classification parity: top-1/top-5 agreement between the port and
    the TFLite oracle on ``n_images`` images cut from generated frames.
    The reference's accuracy IS the TFLite interpreter's output (band
    delegates all math to it, band/backend/tfl/model_executor.cc:
    249-255), so oracle agreement at the same bit-width is exactly
    "accuracy within the stated delta"."""
    it = _interpreter(path)
    d_in = it.get_input_details()[0]
    d_out = it.get_output_details()[0]
    _, height, width, _ = d_in["shape"]
    images = _image_set(n_images, int(width), int(height), d_in["dtype"])
    served = _Served(path, config, exact)
    top1 = top5 = 0
    max_diff = 0
    try:
        for img in images:
            it.set_tensor(d_in["index"], img)
            it.invoke()
            ref = it.get_tensor(d_out["index"]).ravel()
            ours = served.run({d_in["index"]: img})[d_out["index"]].ravel()
            max_diff = max(
                max_diff,
                int(np.abs(ours.astype(np.int64)
                           - ref.astype(np.int64)).max())
                if np.issubdtype(ref.dtype, np.integer)
                else float(np.abs(ours - ref).max()),
            )
            if int(np.argmax(ours)) == int(np.argmax(ref)):
                top1 += 1
            # value-based top-5 (argsort index sets mis-handle tied
            # scores): our top-1 prediction must score within the
            # oracle's 5 highest
            kth = np.sort(ref)[-min(5, ref.size)]
            if ref[int(np.argmax(ours))] >= kth:
                top5 += 1
    finally:
        served.close()
    return {
        "model": path.rsplit("/", 1)[-1],
        "images": len(images),
        "numerics": "exact" if exact else "fast",
        "top1_agreement": top1 / len(images),
        "top5_agreement": top5 / len(images),
        "max_quant_unit_diff": max_diff,
    }


def _iou(a, b) -> float:
    # boxes as [ymin, xmin, ymax, xmax]
    yi0, xi0 = max(a[0], b[0]), max(a[1], b[1])
    yi1, xi1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(yi1 - yi0, 0.0) * max(xi1 - xi0, 0.0)
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def evaluate_detection(path: str, n_samples: int = 20,
                       iou_thresh: float = 0.5,
                       config: Optional[RuntimeConfig] = None) -> Dict:
    """Detection-parity spot check (the SSD analogue of the top-1
    gate): run an SSD-style model (backbone + TFLite_Detection_
    PostProcess) through both engines on random images, match
    detections oracle<->ours by class + IoU, and report AP with the
    oracle's detections as ground truth.  Bit-parity shows up as
    mAP 1.0 / coordinate deltas ~0.  The default config adds a host
    worker to the GPU worker, for the post-process (a host-only op)."""
    it = _interpreter(path)
    d_in = it.get_input_details()[0]
    served = _Served(path, config, exact=True, host_worker=True)
    try:
        rng = np.random.default_rng(0)
        matched, n_ours, n_ref = 0, 0, 0
        score_diff = 0.0
        box_diff = 0.0
        for _ in range(n_samples):
            shape = [int(s) for s in d_in["shape"]]
            if np.issubdtype(d_in["dtype"], np.integer):
                info = np.iinfo(d_in["dtype"])
                img = rng.integers(info.min, info.max + 1, shape).astype(
                    d_in["dtype"])
            else:
                img = rng.standard_normal(shape).astype(d_in["dtype"])
            it.set_tensor(d_in["index"], img)
            it.invoke()
            ref = [it.get_tensor(d["index"])
                   for d in it.get_output_details()]
            ours = served.run({d_in["index"]: img})
            got = [ours[d["index"]] for d in it.get_output_details()]
            # outputs: boxes [1,N,4], classes [1,N], scores [1,N], count
            rb, rc, rs, rn = (ref[0][0], ref[1][0], ref[2][0],
                              int(ref[3].ravel()[0]))
            gb, gc, gs, gn = (got[0][0], got[1][0], got[2][0],
                              int(got[3].ravel()[0]))
            n_ref += rn
            n_ours += gn
            used = set()
            for i in range(gn):
                best, best_j = 0.0, -1
                for j in range(rn):
                    if j in used or int(rc[j]) != int(gc[i]):
                        continue
                    v = _iou(gb[i], rb[j])
                    if v > best:
                        best, best_j = v, j
                if best >= iou_thresh:
                    used.add(best_j)
                    matched += 1
                    score_diff = max(
                        score_diff, float(abs(gs[i] - rs[best_j]))
                    )
                    box_diff = max(
                        box_diff,
                        float(np.abs(gb[i] - rb[best_j]).max()),
                    )
    finally:
        served.close()
    precision = matched / n_ours if n_ours else 1.0
    recall = matched / n_ref if n_ref else 1.0
    return {
        "model": path.rsplit("/", 1)[-1],
        "samples": n_samples,
        "detections_ours": n_ours,
        "detections_oracle": n_ref,
        "matched@iou0.5": matched,
        "precision_vs_oracle": precision,
        "recall_vs_oracle": recall,
        "map_spot_check": min(precision, recall),
        "max_score_diff": score_diff,
        "max_box_coord_diff": box_diff,
    }


USAGE = (
    "usage: python -m band_tpu_torch.tools.evaluate [--fast] "
    "[--config cfg.json] model.tflite [n_samples]\n"
    "       python -m band_tpu_torch.tools.evaluate [--fast] "
    "[--config cfg.json] --top1 model.tflite [n_images]\n"
    "       python -m band_tpu_torch.tools.evaluate [--config cfg.json] "
    "--detection model.tflite [n_samples]"
)


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    # --fast: evaluate the throughput-numerics programs instead of the
    # bit-exact ones — the accuracy gate for enabling fast numerics
    exact = "--fast" not in argv
    argv = [a for a in argv if a != "--fast"]
    config = None
    if "--config" in argv:
        i = argv.index("--config")
        if i + 1 >= len(argv):
            print(USAGE, file=sys.stderr)
            return 2
        config = config_from_json(argv[i + 1])
        del argv[i:i + 2]
    if not argv:
        print(USAGE, file=sys.stderr)
        return 2
    if argv[0] == "--top1":
        n = int(argv[2]) if len(argv) > 2 else 100
        report = evaluate_topk_images(argv[1], n, exact=exact, config=config)
    elif argv[0] == "--detection":
        n = int(argv[2]) if len(argv) > 2 else 20
        report = evaluate_detection(argv[1], n, config=config)
    else:
        n = int(argv[1]) if len(argv) > 1 else 8
        report = evaluate(argv[0], n, exact=exact, config=config)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
