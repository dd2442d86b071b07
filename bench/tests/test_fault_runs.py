"""A run with the timed path broken underneath comes out not correct, once
for each fault a served cell can have (the exchange between chips is not
among them: every cell runs on one chip). The harness's look for a card is
skipped: `main.run` on the CPU at a tiny configuration.

Each operator segment is paced by a sleep, as the host paces it on the
card, so requests queue, batch and are preempted as they are there. A
fault records the requests it reached; a run in which it reached a
compared request has to come out not correct. On the MoE cell, served in
float32 so that no routing near-tie moves a sound request's logits, and
held to the numbers and limits of the qwen3-30b-a3b cells, the faults that
reach a few rows only (half of a batch, a resume after a preemption) are
caught by the count of requests over the per-request limit while the
median logit error stays within its own.
"""
import json
import time

import pytest

from harness import check, main, serve
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.serving.decode_instance import DecodeInstance
from repro_torch.serving.pool import ExecutionPool
from repro_torch.serving.prefill_instance import PrefillInstance

DENSE = "qwen2.5-tiny.qwentrace-tiny"
MOE = "qwen3-moe-tiny-f32.qwentrace-tiny"
SEEDS = [2 ** 32 + s for s in range(3, 11)]
PACE_S = 0.002              # host time of one operator segment
NOMINAL_S_PER_TOKEN = 4e-4  # the paced tiny prefill, about


def _pace(monkeypatch):
    """Each segment takes PACE_S more on the host, and the scheduler's TTFT
    predictor is a nominal one in place of a profile timed under the test
    run's load (which can make every request look doomed, and S-EDF then
    rightly preempts nothing)."""
    from repro_torch.launch import serve as launch_serve
    step = SegmentedPrefill.step

    def paced(self, task):
        time.sleep(PACE_S)
        return step(self, task)
    monkeypatch.setattr(SegmentedPrefill, "step", paced)
    monkeypatch.setattr(launch_serve, "ttft_profile",
                        lambda executor, lengths: {n: NOMINAL_S_PER_TOKEN * n
                                                   for n in lengths})


def _skip_o_proj(monkeypatch, hit):
    """A step that returns its state unchanged: every o_proj segment."""
    step = PrefillInstance._step

    def broken(self, task):
        ex, pt = self.executor, task.prefill_task
        seg = pt.cursor
        if seg < pt.total_segments - 1 and ex.ops[
                seg % ex._segments_per_chunk % len(ex._segments)] == "o_proj":
            hit.update(r.rid for r in task.requests)
            pt.cursor += 1
            return pt.done
        return step(self, task)
    monkeypatch.setattr(PrefillInstance, "_step", broken)


def _half_batch(monkeypatch, hit):
    """Half of each batch left out: its rows' logits are the mean over the
    rest."""
    step = PrefillInstance._step

    def broken(self, task):
        done = step(self, task)
        B = len(task.requests)
        if done and B > 1:
            pt = task.prefill_task
            keep = B - B // 2
            pt.logits = pt.logits.clone()
            pt.logits[keep:] = pt.logits[:keep].float().mean(0).to(
                pt.logits.dtype)
            hit.update(r.rid for r in task.requests[keep:])
        return done
    monkeypatch.setattr(PrefillInstance, "_step", broken)


def _wrong_resume(monkeypatch, hit):
    """A resume after a preemption on a cache that lost what the task wrote
    before it: the keys and values of its earlier chunks read zero."""
    resume = ExecutionPool.resume

    def broken(self, task_id):
        with self._cv:
            task = self._preempted[task_id]
        pt = task.prefill_task
        spc = (pt.total_segments - 1) // pt.n_chunks
        lo = pt.start_offset + min(pt.cursor // spc, pt.n_chunks) * pt.chunk
        if lo > 0:
            pt.state["k_cache"][:, :, :lo] = 0
            pt.state["v_cache"][:, :, :lo] = 0
            hit.update(r.rid for r in task.requests)
        return resume(self, task_id)
    monkeypatch.setattr(ExecutionPool, "resume", broken)


def _altered_token(monkeypatch, hit):
    """The first token altered where it is produced (the handoff)."""
    submit = DecodeInstance.submit

    def broken(self, job):
        job.first_token = (job.first_token + 1) % self.cfg.vocab_size
        hit.add(job.request.rid)
        return submit(self, job)
    monkeypatch.setattr(DecodeInstance, "submit", broken)


def _compared(monkeypatch):
    """Records the rids of the requests each run compares (its sample)."""
    seen = {}
    sample, requests = check.sample, serve.requests

    def rec_sample(*a, **k):
        seen["picked"] = sample(*a, **k)
        return seen["picked"]

    def rec_requests(items):
        seen["reqs"] = requests(items)
        return seen["reqs"]
    monkeypatch.setattr(check, "sample", rec_sample)
    monkeypatch.setattr(serve, "requests", rec_requests)
    return lambda: {seen["reqs"][i].rid for i in seen["picked"]}


FAULTS = {"state_unchanged": _skip_o_proj, "half_batch": _half_batch,
          "wrong_resume": _wrong_resume, "token_altered": _altered_token}


@pytest.mark.parametrize("cell", [DENSE, MOE])
def test_a_sound_path_is_correct(cell, tiny_root, monkeypatch):
    _pace(monkeypatch)
    for seed in SEEDS[:2]:
        out = main.run(tiny_root, cell, seed, 2.0, False, "cpu",
                       time.monotonic())
        assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [DENSE, MOE])
def test_a_broken_path_is_not_correct(cell, fault, tiny_root, monkeypatch):
    _pace(monkeypatch)
    compared = _compared(monkeypatch)
    hit = set()
    FAULTS[fault](monkeypatch, hit)
    reached = []                  # (share of compared requests, checks)
    for seed in SEEDS:
        hit.clear()
        out = main.run(tiny_root, cell, seed, 2.0, False, "cpu",
                       time.monotonic())
        want = compared()
        if hit & want:
            assert not out["correct"], (seed, out["checks"])
            reached.append((len(hit & want) / len(want), out["checks"],
                            seed))
        if len(reached) == 2:
            break
    assert reached, "the fault reached no compared request"
    if cell == MOE and fault in ("half_batch", "wrong_resume"):
        few = [r for r in reached if r[0] < 0.5]
        assert few, reached
        for share, c, seed in few:
            assert c["logit_outliers"]["value"] > 0, (share, c, seed)
            assert c["logit_err"]["value"] <= c["logit_err"]["limit"], c


def test_half_batch_fault_hits_batched_rows(monkeypatch):
    """The planted fault changes the rows it should and no others."""
    from pathlib import Path
    from types import SimpleNamespace

    import torch
    from harness import deploy
    spec = json.loads((Path(__file__).parent / "data" / "configs" /
                       "qwen2.5-tiny.json").read_text())
    cfg = deploy.model_config(spec)
    params = deploy.draw_weights(cfg, 1, torch.device("cpu"), torch.float32)
    ex = SegmentedPrefill(params, cfg, max_seq=64, chunk_tokens=32)
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(0))
    good = ex.run_all(ex.start(toks.numpy()))
    monkeypatch.setattr(PrefillInstance, "_step",
                        lambda self, task: ex.step(task.prefill_task))
    hit = set()
    _half_batch(monkeypatch, hit)
    task = SimpleNamespace(prefill_task=ex.start(toks.numpy()),
                           requests=[SimpleNamespace(rid=i)
                                     for i in range(3)])
    while not PrefillInstance._step(None, task):
        pass
    bad = task.prefill_task.logits
    assert torch.equal(good[:2], bad[:2]) and not torch.equal(good[2], bad[2])
    assert hit == {2}
