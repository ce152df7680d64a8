"""The PyTorch port's copies of the TFLite parser and the analyzer
against band_tpu's: every tests/data model parses to equal graphs, and
both analyzers partition it into equal subgraphs under every
SubgraphPreparationType (tolerance: exact equality)."""

import glob
import os

import numpy as np
import pytest

import band_tpu.ir.analyzer as ja
import band_tpu_torch.ir.analyzer as ta
from band_tpu.common import SubgraphPreparationType as JPrep
from band_tpu.config import SubgraphConfig as JSubgraphConfig
from band_tpu.tflite.parser import parse_tflite_file as jparse
from band_tpu_torch.common import SubgraphPreparationType as TPrep
from band_tpu_torch.config import SubgraphConfig as TSubgraphConfig
from band_tpu_torch.tflite.parser import parse_tflite_file as tparse

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODELS = sorted(os.path.basename(p)[:-7]
                for p in glob.glob(os.path.join(DATA, "*.tflite")))
# the op set of the port's first slice covers these models whole
SLICE_MODELS = ["effnetlite_int8", "fc_int8", "mobilenet_v2_int8",
                "resnetish_int8"]


def _path(name):
    return os.path.join(DATA, f"{name}.tflite")


def _same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))


def _assert_same_graph(jg, tg, top=True):
    assert (jg.name, jg.inputs, jg.outputs, jg.version) == (
        tg.name, tg.inputs, tg.outputs, tg.version)
    assert len(jg.tensors) == len(tg.tensors)
    for jt, tt in zip(jg.tensors, tg.tensors):
        assert (jt.index, jt.name, tuple(jt.shape), jt.ttype.name) == (
            tt.index, tt.name, tuple(tt.shape), tt.ttype.name)
        assert jt.dtype == tt.dtype
        assert (jt.quant is None) == (tt.quant is None)
        if jt.quant is not None:
            assert _same_array(jt.quant.scale, tt.quant.scale)
            assert _same_array(jt.quant.zero_point, tt.quant.zero_point)
            assert jt.quant.quantized_dimension == tt.quant.quantized_dimension
        assert _same_array(jt.data, tt.data)
    assert len(jg.ops) == len(tg.ops)
    for jo, to in zip(jg.ops, tg.ops):
        assert (jo.index, jo.opname, jo.inputs, jo.outputs, jo.version) == (
            to.index, to.opname, to.inputs, to.outputs, to.version)
        assert jo.options.keys() == to.options.keys()
        for k in jo.options:
            a, b = jo.options[k], to.options[k]
            if isinstance(a, np.ndarray):
                assert _same_array(a, b)
            else:
                assert a == b, (jo.opname, k)
    if top:
        # every graph of a control-flow model lists all of the model's
        # graphs (the main one too): compare them once, from the top
        jsubs = [s for s in jg.subgraphs or [] if s is not jg]
        tsubs = [s for s in tg.subgraphs or [] if s is not tg]
        assert len(jsubs) == len(tsubs)
        for js, ts in zip(jsubs, tsubs):
            _assert_same_graph(js, ts, top=False)


@pytest.mark.parametrize("name", MODELS)
def test_parsers_agree(name):
    _assert_same_graph(jparse(_path(name)), tparse(_path(name)))


def _defs(analyzer, graph, prep, hosts, fallback, subgraph_config):
    spec = analyzer.build_model_spec(graph, hosts)
    defs = analyzer.ModelAnalyzer(
        graph, spec, len(hosts), subgraph_config(
            minimum_subgraph_size=2, subgraph_preparation_type=prep),
        fallback,
    ).create_subgraphs()
    return spec, sorted(
        (d.worker_id, tuple(sorted(d.op_indices)),
         tuple(sorted(d.unit_indices))) for d in defs)


def _assert_same_partition(name, prep_name, hosts, fallback):
    jg, tg = jparse(_path(name)), tparse(_path(name))
    jspec, jdefs = _defs(ja, jg, JPrep[prep_name], hosts, fallback,
                         JSubgraphConfig)
    tspec, tdefs = _defs(ta, tg, TPrep[prep_name], hosts, fallback,
                         TSubgraphConfig)
    assert jspec.unsupported_ops == tspec.unsupported_ops
    assert jspec.unit_subgraph_ops == tspec.unit_subgraph_ops
    assert jspec.unit_dependencies == tspec.unit_dependencies
    assert jdefs == tdefs


PREPS = [p.name for p in JPrep]


@pytest.mark.parametrize("prep_name", PREPS)
@pytest.mark.parametrize("name", MODELS)
def test_analyzers_agree_under_the_same_op_support(name, prep_name,
                                                   monkeypatch):
    """The partitioning algorithm, with the port's op-support probe
    replaced by band_tpu's (the port supports fewer ops so far): one
    accelerator and one host worker, with and without fallback."""
    monkeypatch.setattr(ta, "op_supported_on_worker",
                        ja.op_supported_on_worker)
    for fallback in (False, True):
        _assert_same_partition(name, prep_name, [False, True], fallback)


@pytest.mark.parametrize("prep_name", PREPS)
@pytest.mark.parametrize("name", SLICE_MODELS)
def test_analyzers_agree_on_the_slice_models(name, prep_name):
    """Unpatched: on the models whose ops the port lowers, its own
    op-support probe gives band_tpu's partition."""
    for fallback in (False, True):
        _assert_same_partition(name, prep_name, [False, True], fallback)
