"""The grouped expert kernel (`kernels/moe_grouped.py`) on the card against
the plain version `moe_apply_ref`, at the published widths of
Qwen3-30B-A3B (E 128, k 8, D 2048, F 768) and Kanana-2-30B-A3B (k 6), at
n 1, 37, 330, 512 and 4096 tokens (8 groups of 512). Each test skips
without a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_moe_cuda.py -q

- The routing the kernel leaves in its workspace equals `moe_route_ref`
  exactly (queue positions, kept pairs and their rows, counts, offsets
  and the M tile list), drop-free at capacity factor E/k and at 1.25,
  where pairs drop, also where one expert takes every token and most
  experts get none, and over an expert range (e0, El).
- Outputs in bf16: the kernel and the plain version are each held to the
  same computation in f32 (`moe_apply_ref` on the bf16 inputs cast to
  f32, the same pairs). The kernel rounds the gate|up product once
  (silu(g) u from the f32 accumulators) where the plain version rounds
  gate, up, silu and the product to bf16, so its error may not exceed the
  plain version's: relative norm at most 1.25x and largest element at most
  2x the plain version's, the room being the two products' different f32
  summation orders and one shared bf16 rounding of ye and of the output.
- f32, and bf16 at widths the tensor-core GEMMs do not take, run the
  CUDA-core GEMMs: within 2e-5 (f32, the port's kernel tolerance) of the
  plain version.
- One capture of the operator in a CUDA graph, replayed on new routing,
  equals the eager call bit for bit (the kernel sizes nothing from the
  routing and makes no host sync).
- `moe_grouped_gemm` counts one per call and `moe_apply_ref` none; a call
  that needs a gradient takes the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_grouped as MG
from repro_torch.kernels import ops
from repro_torch.models import layers as L

pytestmark = pytest.mark.cuda

E, D, F = 128, 2048, 768
# (id, k, n tokens as (B, S))
SHAPES = [("qwen3_n1", 8, (1, 1)), ("qwen3_n37", 8, (1, 37)),
          ("qwen3_n330", 8, (1, 330)), ("qwen3_chunk512", 8, (1, 512)),
          ("qwen3_8x512", 8, (8, 512)), ("kanana_n1", 6, (1, 1)),
          ("kanana_n37", 6, (1, 37)), ("kanana_n330", 6, (1, 330)),
          ("kanana_chunk512", 6, (1, 512)), ("kanana_8x512", 6, (8, 512))]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def experts(card):
    """All 128 experts at the published widths in bf16, fan-in scaled."""
    gen = torch.Generator(device=card).manual_seed(0)
    wi = torch.randn((E, D, 2 * F), generator=gen, device=card) / D ** 0.5
    wd = torch.randn((E, F, D), generator=gen, device=card) / F ** 0.5
    return wi.bfloat16(), wd.bfloat16()


def _routing(B, S, k, skew, seed, device):
    """x (B, S, D) bf16, weights (B, S, k) f32 and idx (B, S, k) int64 of k
    distinct experts a token: uniform, every token's slot 0 on expert 5
    ("one"), or all from 12 experts ("few")."""
    rng = np.random.default_rng(seed)
    n = B * S
    pool = np.arange(E) if skew != "few" else rng.choice(E, 12, replace=False)
    idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(n)])
    if skew == "one":
        idx[idx == 5] = idx[:, :1][(idx == 5).any(1)].ravel()
        idx[:, 0] = 5
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device=device).bfloat16()
    w = torch.softmax(torch.randn((B, S, k), generator=gen, device=device),
                      -1)
    return x, w, torch.as_tensor(idx, device=device).view(B, S, k)


def _errs(got, want, truth):
    """(relative norm, largest element) of got's and want's distance from
    truth, in f32."""
    t = truth.float()
    out = []
    for y in (got, want):
        d = (y.float() - t)
        out.append((float(d.norm() / t.norm()), float(d.abs().max())))
    return out


def _routing_left_in(workspace, n, k, G, cap, Etot, e0, El):
    """The routing a call left in its workspace (the kernel's `layout`), in
    `moe_route_ref`'s terms: `pos`, `rows`, `counts`, `row_off`, `tiles`."""
    off = MG.layout(n, k, G, Etot, El, D, F, 2)

    def part(name, count):
        i = MG.PARTS.index(name)
        return workspace[off[i]:off[i] + count * 4].view(torch.int32).long()

    last = part("cnt", G * Etot).view(G, Etot)[-1, e0:e0 + El].clamp(max=cap)
    n_tiles = int(part("meta", 1)[0])
    return {"pos": part("pos", n * k), "rows": part("pair_row", n * k),
            "counts": part("grp_base", G * El).view(G, El)[-1] + last,
            "row_off": part("row_off", El),
            "tiles": part("tiles", n_tiles * 4).view(n_tiles, 4)[:, :3]}


def _check_against_plain(x, w, idx, wi, wd, k, cf, e0=0, n_experts=0):
    """The kernel's routing against `moe_route_ref` and its output against
    the plain version's, both against f32; returns the routing."""
    B, S, _ = x.shape
    n = B * S
    El = wi.shape[0]
    Etot = n_experts or El
    G, _, cap = L.moe_groups(n, k, Etot, F, capacity_factor=cf,
                             min_capacity=4)
    size = MG.layout(n, k, G, Etot, El, D, F, 2)[-1]
    ws = torch.empty(size, dtype=torch.uint8, device=x.device)
    ops.reset_counts()
    got = MG.moe_grouped_ffn(x.view(n, D), w.view(n, k), idx.view(n, k), wi,
                             wd, n_groups=G, cap=cap, n_experts=n_experts,
                             e0=e0, workspace=ws).view(B, S, D)
    torch.cuda.synchronize()
    c = MG.counts()
    assert c["moe_grouped_gemm"] == 1 and c["moe_grouped_wgmma"] == 1
    kw = dict(k=k, capacity_factor=cf, min_capacity=4, e0=e0,
              n_experts=n_experts)
    want = L.moe_apply_ref(x, w, idx, wi, wd, **kw)
    truth = L.moe_apply_ref(x.float(), w, idx, wi.float(), wd.float(), **kw)
    assert MG.counts()["moe_apply_ref"] == 2
    (kn, km), (rn, rm) = _errs(got, want, truth)
    assert kn <= 1.25 * rn + 1e-6, (kn, rn)
    assert km <= 2.0 * rm + 1e-6, (km, rm)

    route = _routing_left_in(ws, n, k, G, cap, Etot, e0, El)
    twin = L.moe_route_ref(idx, G, Etot, cap, e0=e0, n_local=El)
    in_range = (idx.view(-1) >= 0) & (idx.view(-1) < Etot)
    assert torch.equal(route["pos"][in_range], twin["pos"].view(-1)[in_range])
    for key in ("rows", "counts", "row_off", "tiles"):
        assert torch.equal(route[key], twin[key]), key
    return twin


@pytest.mark.parametrize("cf", ["drop_free", 1.25])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_grouped_kernel_matches_plain(card, experts, shape, cf):
    _, k, (B, S) = shape
    cf = E / k if cf == "drop_free" else cf
    x, w, idx = _routing(B, S, k, None, seed=B * S + k, device=card)
    twin = _check_against_plain(x, w, idx, *experts, k, cf)
    if cf == E / k:
        assert bool(twin["keep"].all())


@pytest.mark.parametrize("skew", ["one", "few"])
@pytest.mark.parametrize("cf", ["drop_free", 1.25])
@pytest.mark.parametrize("shape", [SHAPES[3], SHAPES[4], SHAPES[8]],
                         ids=[SHAPES[i][0] for i in (3, 4, 8)])
def test_grouped_kernel_on_skewed_routing(card, experts, shape, cf, skew):
    """One expert takes every token (4096 rows of expert 5 at 8 x 512), or
    116 of the 128 experts get no token."""
    _, k, (B, S) = shape
    cf = E / k if cf == "drop_free" else cf
    x, w, idx = _routing(B, S, k, skew, seed=B * S + 7, device=card)
    twin = _check_against_plain(x, w, idx, *experts, k, cf)
    counts = twin["counts"]
    if skew == "few":
        assert int((counts == 0).sum()) >= E - 12
    if cf != E / k:
        assert not bool(twin["keep"].all())


@pytest.mark.parametrize("rng_", [(0, 64), (32, 48), (100, 28)])
@pytest.mark.parametrize("cf", ["drop_free", 1.25])
def test_grouped_kernel_over_an_expert_range(card, experts, rng_, cf):
    """A rank's experts [e0, e0 + El) of 128 (the sharded path): the other
    experts' pairs weigh 0, every pair still takes its queue place."""
    e0, El = rng_
    k = 8
    cf = E / k if cf == "drop_free" else cf
    wi, wd = experts
    x, w, idx = _routing(1, 512, k, None, seed=e0 + El, device=card)
    _check_against_plain(x, w, idx, wi[e0:e0 + El], wd[e0:e0 + El], k, cf,
                         e0=e0, n_experts=E)


@pytest.mark.parametrize("case", [("f32_published", torch.float32, D, F),
                                  ("bf16_d192", torch.bfloat16, 192, 96),
                                  ("f32_tiny", torch.float32, 64, 32)],
                         ids=lambda c: c[0])
def test_cuda_core_gemms_match_plain(card, case):
    """f32, and bf16 at D 192 / F 96 (not multiples of 128 / 64), run the
    CUDA-core GEMMs over the same routing: 2e-5 in f32 against the plain
    version on the card; in bf16 the bf16 tolerance of the other card
    tests plus the intermediate's rounding (the plain version rounds gate,
    up and silu before the product), held to 2x the plain version's
    distance from f32."""
    _, dtype, Dm, Fm = case
    gen = torch.Generator(device=card).manual_seed(3)
    El, k, n = 16, 4, 96
    wi = (torch.randn((El, Dm, 2 * Fm), generator=gen, device=card)
          / Dm ** 0.5).to(dtype)
    wd = (torch.randn((El, Fm, Dm), generator=gen, device=card)
          / Fm ** 0.5).to(dtype)
    x = torch.randn((1, n, Dm), generator=gen, device=card).to(dtype)
    w = torch.softmax(torch.randn((1, n, k), generator=gen, device=card), -1)
    idx = torch.stack([torch.randperm(El, generator=gen, device=card)[:k]
                       for _ in range(n)])[None]
    kw = dict(k=k, capacity_factor=1.0, min_capacity=4, group_size=32)
    ops.reset_counts()
    got = L.moe_apply(x, w, idx, wi, wd, **kw)
    c = MG.counts()
    assert c["moe_grouped_gemm"] == 1 and c["moe_grouped_wgmma"] == 0
    assert c["moe_apply_ref"] == 0
    want = L.moe_apply_ref(x, w, idx, wi, wd, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        truth = L.moe_apply_ref(x.float(), w, idx, wi.float(), wd.float(),
                                **kw)
        (kn, km), (rn, rm) = _errs(got, want, truth)
        assert kn <= 2 * rn and km <= 2 * rm, (kn, rn, km, rm)


def test_grouped_kernel_replays_from_a_cuda_graph(card, experts):
    """`moe_apply` captured once on static buffers at 512 tokens (added
    into a residual, as the segment does), then replayed on new routing:
    equal bit for bit to the eager call on the same inputs."""
    wi, wd = experts
    k = 8
    kw = dict(k=k, capacity_factor=1.25, min_capacity=4)
    x, w, idx = _routing(1, 512, k, None, seed=1, device=card)
    h = torch.randn((512, D), device=card).bfloat16()
    sx, sw, sidx, sh = x.clone(), w.clone(), idx.clone(), h.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):             # warm: build and load
        L.moe_apply(sx, sw, sidx, wi, wd, **kw, residual=sh.clone())
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L.moe_apply(sx, sw, sidx, wi, wd, **kw, residual=sh)
    for seed in (2, 3, 4):
        x, w, idx = _routing(1, 512, k, "few" if seed == 3 else None,
                             seed=seed, device=card)
        sx.copy_(x)
        sw.copy_(w)
        sidx.copy_(idx)
        sh.copy_(h)
        ops.reset_counts()
        graph.replay()
        want = L.moe_apply(x, w, idx, wi, wd, **kw, residual=h.clone())
        torch.cuda.synchronize()
        assert MG.counts()["moe_grouped_gemm"] == 1     # the eager call
        assert torch.equal(sh, want)
        assert not torch.equal(sh, h)


def test_counts_and_the_gradient_path(card, experts):
    """A served call counts one `moe_grouped_gemm` and no plain call; a
    call that needs a gradient runs the plain version and back-propagates
    to x and the weights."""
    wi, wd = experts
    k = 8
    kw = dict(k=k, capacity_factor=16.0, min_capacity=4)
    x, w, idx = _routing(1, 37, k, None, seed=9, device=card)
    ops.reset_counts()
    for _ in range(3):
        L.moe_apply(x, w, idx, wi, wd, **kw)
    c = MG.counts()
    assert (c["moe_grouped_gemm"], c["moe_apply_ref"]) == (3, 0)
    xg = x.float().requires_grad_()
    wig = wi[:, :64, :].float().contiguous()
    y = L.moe_apply(xg[..., :64].contiguous(), w, idx,
                    wig.requires_grad_(), wd[:, :, :64].float(), **kw)
    y.float().square().sum().backward()
    c = MG.counts()
    assert (c["moe_grouped_gemm"], c["moe_apply_ref"]) == (3, 1)
    assert xg.grad is not None and wig.grad is not None
    assert float(wig.grad.abs().sum()) > 0
