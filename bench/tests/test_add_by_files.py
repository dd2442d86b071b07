"""A configuration, a traffic mix or a per-layer metric is added by adding
files (and the cell's entry in BENCHMARK.json): here a mix and a metric in
a copy, with no existing file of bench/ edited."""
import hashlib
import json
import time

from harness import main


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
