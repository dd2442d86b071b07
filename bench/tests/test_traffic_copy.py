"""The frozen generator copies give the program's traces for the same seed,
and every run seed offers the same work in the same order."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from harness import traffic
from repro_torch.traces import qwentrace as program

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
sys.path.insert(0, str(TRAFFIC))
import sharegpt_like  # noqa: E402
import tasks_lognormal  # noqa: E402


@pytest.mark.parametrize("seed,rate,max_len", [(0, 2.0, 32768),
                                               (7, 5.5, 16384),
                                               (2 ** 31 + 5, 1.0, 4096)])
def test_tasks_lognormal_equals_qwentrace(seed, rate, max_len):
    want = program.generate(program.TraceConfig(
        model="qwen3-30b-a3b", rate=rate, duration=60.0, seed=seed,
        max_len=max_len))
    table = {t: {k: v[k] for k in ("mean", "std", "ratio")}
             for t, v in program.TABLE1.items()}
    got = tasks_lognormal.generate(table, rate, 60.0, seed, max_len=max_len)
    assert [(r.arrival, r.task_type, r.num_tokens) for r in want] == got
    assert json.loads((TRAFFIC / "qwentrace.json").read_text())["tasks"] == \
        table


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 9])
def test_sharegpt_like_equals_the_program(seed):
    want = program.sharegpt_like(n=300, rate=4.0, seed=seed, max_len=2048)
    got = sharegpt_like.generate(300, 4.0, seed, max_len=2048)
    assert [(r.arrival, r.num_tokens) for r in want] == got


def test_draw_is_the_prefix_of_the_trace():
    mix = json.loads((TRAFFIC / "qwentrace.json").read_text())
    tasks, lengths, gaps = tasks_lognormal.draw(mix, 50, 3.0)
    want = []
    for t, task, n in tasks_lognormal._requests(mix["tasks"], 3.0,
                                                mix["base_seed"],
                                                mix["min_len"],
                                                mix["max_len"]):
        want.append((t, task, n))
        if len(want) == 50:
            break
    assert [w[1] for w in want] == tasks and [w[2] for w in want] == lengths
    assert np.allclose(np.cumsum(gaps), [w[0] for w in want])


@pytest.mark.parametrize("name", ["qwentrace", "sharegpt"])
def test_every_seed_offers_the_same_work(name):
    mix = json.loads((TRAFFIC / f"{name}.json").read_text())
    slos = {"text": 0.25, "image": 0.5, "search": 4.0, "file": 6.0}
    a = traffic.schedule(TRAFFIC, mix, 4.0, 30.0, 11, slos, 1000)
    b = traffic.schedule(TRAFFIC, mix, 4.0, 30.0, 2 ** 33 + 1, slos, 1000)
    assert len(a) == len(b) == 120
    assert [(it.task, it.n, it.offset) for it in a] == \
        [(it.task, it.n, it.offset) for it in b]
    tasks, lengths, _ = traffic.generator(TRAFFIC, mix["generator"]).draw(
        mix, 120, 4.0)
    assert [it.task for it in a] == tasks and [it.n for it in a] == lengths
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert a[-1].offset == pytest.approx(30.0)
    assert all(len(it.tokens) == it.n for it in a)
    again = traffic.schedule(TRAFFIC, mix, 4.0, 30.0, 11, slos, 1000)
    assert all(np.array_equal(x.tokens, y.tokens) and x.offset == y.offset
               for x, y in zip(a, again))
