"""A configuration, a traffic mix or a per-layer metric is added by adding
files (and the cell's entry in BENCHMARK.json): here a mix and a metric,
and a configuration of a new architecture, in a copy, with no existing
file of bench/ edited."""
import hashlib
import json
import time

import pytest

from harness import deploy, main


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_mix_and_metric_are_new_files(tiny_root):
    before = _digests(tiny_root)
    bench = tiny_root / "bench"
    (bench / "traffic" / "burst-tiny.json").write_text(json.dumps({
        "generator": "sharegpt_like", "task": "image", "mean": 20, "std": 10,
        "min_len": 8, "max_len": 64, "max_seq": 64, "base_seed": 4}))
    (bench / "cells" / "qwen2.5-tiny.burst-tiny.json").write_text(json.dumps({
        "rate_rps": 10.0, "check": {"requests": 4, "tokens": 256},
        "limits": {"token_gap": 1.5, "logit_err": 0.06, "kv_err": 0.05}}))
    (bench / "metrics" / "prompt_tokens_per_s.py").write_text(
        '"""Prompt tokens of the requests served, per second of the '
        'window."""\nimport math\n\n\ndef read(run):\n'
        '    return sum(n for n, t in zip(run.n, run.ttft)\n'
        '               if math.isfinite(t)) / run.seconds\n')
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "qwen2.5-tiny.burst-tiny",
                              "config": "qwen2.5-tiny",
                              "traffic": "burst-tiny", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({
        "name": "prompt_tokens_per_s", "unit": "tokens/s", "better": "higher",
        "source": "host_clock", "layer": "prefill scheduler",
        "moves": "goodput_rps", "workloads": ["qwen2.5-tiny.burst-tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    out = main.run(tiny_root, "qwen2.5-tiny.burst-tiny", 9, 1.5, True, "cpu",
                   time.monotonic())
    assert out["correct"]
    assert out["metrics"]["prompt_tokens_per_s"]["value"] > 0
    assert "prompt_tokens_per_s" not in main.run(
        tiny_root, "qwen2.5-tiny.sharegpt-tiny", 9, 1.5, True, "cpu",
        time.monotonic())["metrics"]


# --- a configuration of a new architecture ---------------------------------

WINDOW = 32

# bench/arch/windowed.py: the decoder with every layer's attention inside a
# sliding window; ModelConfig.local_window is no field the decoder's table
# carries
WINDOWED_ARCH = '''"""A decoder whose every layer attends within a sliding window of
`sliding_window` keys: the decoder's module, the window added."""
from pathlib import Path

from harness import files
from harness.stats import HBM_BYTES_PER_S, PEAK_BF16_OPS

decoder = files.arch(Path(__file__).parent, "decoder")
HANDOFF = decoder.HANDOFF
ATTENTION_KERNELS = decoder.ATTENTION_KERNELS


def model_config(spec):
    return decoder.model_config(spec, local_window=spec["sliding_window"])


def _pairs(Sq, q_offset, W):
    return sum(min(q_offset + i + 1, W) for i in range(Sq))


def attention_work(Sq, q_offset, cfg, spec, es):
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    keys = min(q_offset + Sq, cfg.local_window - 1 + Sq)
    return (4.0 * hd * H * _pairs(Sq, q_offset, cfg.local_window),
            es * (2 * Sq * H * hd + 2 * keys * K * hd))


def prompt_attention_bound(n, chunk, cfg, spec, es):
    total = 0.0
    for lo in range(0, n, chunk):
        ops, nbytes = attention_work(min(chunk, n - lo), lo, cfg, spec, es)
        total += max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)
    return total * cfg.num_layers


def model_flops(n, cfg, spec):
    hidden = n * (n + 1) // 2 - _pairs(n, 0, cfg.local_window)
    return decoder.model_flops(n, cfg, spec) - cfg.num_layers * 4.0 * \\
        cfg.resolved_head_dim * cfg.num_heads * hidden
'''

# bench/reference/windowed.py: the decoder reference, each query seeing its
# last `sliding_window` keys
WINDOWED_REFERENCE = '''"""Plain float32 forward of a decoder whose every layer attends within a
sliding window of `sliding_window` keys: the decoder reference with the
window mask."""
import importlib.util
import math
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "windowed_decoder", Path(__file__).with_name("decoder.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)


def forward(weights, config, prompts, *, kv_layers=(), fp8=False):
    W = config["sliding_window"]

    def attention(q, k, v, prec, block=512):
        n, H, hd = q.shape
        K = k.shape[1]
        qg = prec.act(q).reshape(n, K, H // K, hd).permute(1, 2, 0, 3)
        s = qg @ prec.act(k).permute(1, 2, 0)[:, None] / math.sqrt(hd)
        i = torch.arange(n, device=q.device)[:, None]
        j = torch.arange(n, device=q.device)[None, :]
        s = s.masked_fill((j > i) | (j <= i - W), float("-inf"))
        p = torch.softmax(s, dim=-1)
        out = prec.act(p) @ prec.act(v).permute(1, 0, 2)[:, None]
        return out.permute(2, 0, 1, 3).reshape(n, H * hd)

    base.causal_attention = attention
    return base.forward(weights, config, prompts, kv_layers=kv_layers,
                        fp8=fp8)
'''


def _windowed_port(monkeypatch):
    """The port's config module of the windowed stack (a tiny dense stack
    with local_window set), registered as repro_torch.configs.window_tiny."""
    import sys
    import types

    from repro_torch.configs.base import ModelConfig
    mod = types.ModuleType("repro_torch.configs.window_tiny")
    mod.CONFIG = ModelConfig(
        name="window-tiny", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, qkv_bias=True,
        tie_embeddings=True, local_window=WINDOW)
    mod.tiny = lambda: mod.CONFIG
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def _add_windowed(root):
    """The new architecture's files and BENCHMARK.json entries: its
    configuration, bench/arch/windowed.py, bench/reference/windowed.py and
    one cell on the tiny QwenTrace, reporting what the tiny dense cells
    report."""
    bench = root / "bench"
    spec = json.loads((bench / "configs" / "qwen2.5-tiny.json").read_text())
    spec.update(name="window-tiny", port_arch="window_tiny",
                reference="windowed", sliding_window=WINDOW,
                use_sliding_window=True,
                source="a tiny dense stack with every layer windowed")
    (bench / "configs" / "window-tiny.json").write_text(json.dumps(spec))
    (bench / "arch" / "windowed.py").write_text(WINDOWED_ARCH)
    (bench / "reference" / "windowed.py").write_text(WINDOWED_REFERENCE)
    dense = "qwen2.5-tiny.qwentrace-tiny"
    cell = "window-tiny.qwentrace-tiny"
    (bench / "cells" / f"{cell}.json").write_bytes(
        (bench / "cells" / f"{dense}.json").read_bytes())
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "window-tiny", "source": "tiny",
                          "file": "bench/configs/window-tiny.json",
                          "reduced": [], "why": "a test"})
    bj["workloads"].append({"name": cell, "config": "window-tiny",
                            "traffic": "qwentrace-tiny", "chips": 1,
                            "why": "a test"})
    for m in bj["per_layer"]:
        if dense in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    return cell


def test_a_new_architecture_is_new_files(tiny_root, monkeypatch):
    """A configuration whose port config sets a field the decoder's table
    does not carry (a sliding window) reaches the program through its own
    architecture module, and is correct against its own reference; the
    plain decoder reference in its place is not correct, so the window
    reached the program."""
    _windowed_port(monkeypatch)
    before = _digests(tiny_root)
    cell = _add_windowed(tiny_root)
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(tiny_root) for p in (
            tiny_root / "bench" / "configs" / "window-tiny.json",
            tiny_root / "bench" / "arch" / "windowed.py",
            tiny_root / "bench" / "reference" / "windowed.py",
            tiny_root / "bench" / "cells" / f"{cell}.json")}
    served = []
    build = deploy.build
    monkeypatch.setattr(deploy, "build", lambda cfg, *a, **k: served.append(
        cfg) or build(cfg, *a, **k))
    out = main.run(tiny_root, cell, 2 ** 31 + 91, 2.0, True, "cpu",
                   time.monotonic())
    assert served[0].local_window == WINDOW
    assert out["correct"], out["checks"]
    assert out["metrics"]["prefill_mfu"]["value"] > 0
    ref = tiny_root / "bench" / "reference"
    (ref / "windowed.py").write_bytes((ref / "decoder.py").read_bytes())
    out = main.run(tiny_root, cell, 2 ** 31 + 91, 2.0, False, "cpu",
                   time.monotonic())
    assert not out["correct"], out["checks"]


def test_a_new_architecture_with_a_width_off_is_refused(tiny_root,
                                                         monkeypatch):
    _windowed_port(monkeypatch)
    cell = _add_windowed(tiny_root)
    path = tiny_root / "bench" / "configs" / "window-tiny.json"
    good = path.read_text()
    for key, value in (("sliding_window", WINDOW // 2),
                       ("num_key_value_heads", 4)):
        spec = json.loads(good)
        spec[key] = value
        path.write_text(json.dumps(spec))
        with pytest.raises(ValueError, match="widths differ"):
            main.run(tiny_root, cell, 5, 1.0, False, "cpu", time.monotonic())
