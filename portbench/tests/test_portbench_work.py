"""The work counts of portbench/work.py against totals worked by hand."""

import os

import pytest

from portbench import work as W
from portbench.reference.tflite import read_model
from portbench.tests.conftest import ROOT

DATA = os.path.join(ROOT, "tests", "data")


def test_mobilenet_v2_mac():
    model = read_model(os.path.join(DATA, "mobilenet_v2_int8.tflite"))
    ops = W.conv_family(model)
    assert [o.name for o in ops].count("CONV_2D") == 35
    assert [o.name for o in ops].count("DEPTHWISE_CONV_2D") == 17
    # the stem: 112 * 112 * 32 outputs of a 3x3x3 window
    assert ops[0].mac == 112 * 112 * 32 * 27
    # the classifier: 1280 -> 1000
    assert ops[-1].name == "FULLY_CONNECTED" and ops[-1].mac == 1280 * 1000
    total = W.mac_per_request(model)
    assert total == 300_774_272  # "about 300 M", MobileNetV2 1.0/224
    assert 0.29e9 < total < 0.31e9


def test_fsrcnn_mac_by_hand():
    model = read_model(os.path.join(DATA, "fsrcnn_x2_int8.tflite"))
    px = 360 * 640
    hand = [
        px * 56 * 5 * 5 * 1,  # feature extraction, 5x5, 1 -> 56
        px * 12 * 56,  # shrinking, 1x1
        px * 12 * 9 * 12, px * 12 * 9 * 12,  # four 3x3 mappings
        px * 12 * 9 * 12, px * 12 * 9 * 12,
        px * 56 * 12,  # expanding, 1x1
        # the 9x9 stride-2 deconvolution per output pixel: 720 x 1280
        # outputs, each 9 * 9 / 4 taps of 56 channels on average
        720 * 1280 * (9 * 9 * 56) // 4,
    ]
    ops = W.conv_family(model)
    assert [o.mac for o in ops] == hand
    assert W.mac_per_request(model) == sum(hand) == 2_871_705_600


def test_bytes_and_bound():
    model = read_model(os.path.join(DATA, "fsrcnn_x2_int8.tflite"))
    deconv = W.conv_family(model)[-1]
    # input 360x640x56 and output 720x1280 int8 each window request,
    # 9x9x56 weights and one int32 bias once a window
    assert deconv.act_bytes == 360 * 640 * 56 + 720 * 1280
    assert deconv.const_bytes == 9 * 9 * 56 + 4
    b = 8
    assert deconv.bytes(b) == b * deconv.act_bytes + deconv.const_bytes
    assert deconv.bound_s(b) == pytest.approx(max(
        2 * deconv.mac * b / W.INT8_OPS_PER_S,
        deconv.bytes(b) / W.HBM_BYTES_PER_S))
    assert W.bound_s([deconv], {8: 3, 4: 1}) == pytest.approx(
        3 * deconv.bound_s(8) + deconv.bound_s(4))


class _Event:
    def __init__(self, kind, start, end):
        self.kind, self.start, self.end = kind, start, end

    def activity_type(self):
        return self.kind

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_card_busy_is_the_union_of_device_events():
    from portbench.trace import card_busy

    events = [_Event("kernel", 0, 4000), _Event("kernel", 2000, 6000),
              _Event("gpu_memcpy", 10000, 11000),
              _Event("gpu_memset", 20000, 20500),
              # an op's device-side span is no work, a runtime call is
              # the host's
              _Event("gpu_user_annotation", 0, 30000),
              _Event("cuda_runtime", 6000, 9000)]
    busy, kinds = card_busy(events)
    assert busy == pytest.approx(7.5e-6)
    assert kinds == {"kernel": 2, "gpu_memcpy": 1, "gpu_memset": 1}


class _OldEvent:
    """An event of a torch whose events carry no activity type."""

    def __init__(self, name, on_card, start, end):
        self._name, self.on_card, self.start, self.end = (name, on_card,
                                                          start, end)

    def name(self):
        return self._name

    def device_type(self):
        import torch

        kinds = torch._C._autograd.DeviceType
        return kinds.CUDA if self.on_card else kinds.CPU

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_card_busy_without_activity_types():
    from portbench.trace import card_busy

    events = [_OldEvent("qmatmul_kernel", True, 0, 4000),
              _OldEvent("Memcpy HtoD (Pageable -> Device)", True, 3000, 6000),
              _OldEvent("Memset (Device)", True, 8000, 9000),
              _OldEvent("op003_ADD", True, 0, 30000),
              _OldEvent("portbench.send", True, 0, 30000),
              _OldEvent("cudaLaunchKernel", False, 10000, 20000)]
    busy, kinds = card_busy(events)
    assert busy == pytest.approx(7e-6)
    assert kinds == {"kernel": 1, "gpu_memcpy": 1, "gpu_memset": 1}
