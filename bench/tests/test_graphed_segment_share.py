"""`graphed_segment_share` on hand-made spans: the share of `segment` spans
whose `graphed` attribute is True, and None where no span carries it (a
program from before the attribute) or there are no spans."""
from types import SimpleNamespace

import pytest

from conftest import BENCH
from harness import files
from repro_torch.tracing import Span


def _read(run):
    return files.reader(BENCH / "metrics", "graphed_segment_share")(run)


def _segment(start, **attrs):
    return Span("segment", start, start + 1e-4, 1, 1, 0, 7, attrs)


def test_the_share_of_graphed_segments_by_hand():
    got = [_segment(0.0, op="qkv_proj", graphed=True),
           _segment(0.1, op="attn", graphed=False),
           _segment(0.2, op="o_proj", graphed=True),
           _segment(0.3, op="head", graphed=False),
           Span("device_wait", 0.0, 0.5, 1, 1, 0, 7, {"graphed": False}),
           Span("round", 0.0, 0.5, 1, 1, 0, None, {})]
    assert _read(SimpleNamespace(spans=got)) == pytest.approx(50.0)
    assert _read(SimpleNamespace(spans=got[:1])) == pytest.approx(100.0)
    assert _read(SimpleNamespace(spans=got[1:2])) == 0.0


def test_silent_where_no_span_carries_the_attribute():
    old = [Span("segment", 0.0, 1e-4, 1, 1, 0, 7,
                {"op": "qkv_proj", "layer": 0, "chunk": 0})]
    assert _read(SimpleNamespace(spans=old)) is None
    assert _read(SimpleNamespace(spans=[])) is None
    assert _read(SimpleNamespace(trace=None)) is None
