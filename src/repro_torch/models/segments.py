"""Operator-segmented prefill: FlowPrefill's operator-level preemption
(§5.1, Fig. 6) on eager PyTorch.

Counterpart of src/repro/models/segments.py. The prefill runs as a sequence
of segments, each a plain function over a state dict that lives on the
device; the host checks the preemption flag between segments, and a
suspended task is simply one that is not stepped (its state stays on the
device, nothing is recomputed on resume).

Operator sets (paper §5.1 / §6.5):
    dense:  qkv_proj | attn | o_proj | gate_up_proj | down_proj
    moe:    qkv_proj | attn | o_proj | gate | experts
A vlm runs the dense set; its patch embeddings replace the leading
positions of chunk 0 (`start(..., vision_embeds=)`). Boundary granularity
is op / layer / block<k> / whole (Fig. 12). With ``chunk_tokens > 0`` the
prompt is split into chunks, each running all layers at its q_offset
(Fig. 15); the `attn` operator is the flash-prefill kernel on the card. As
in the reference, a chunk's B * Sc tokens form the MoE groups, so a chunked
MoE prefill may drop other pairs than an unchunked one.

Each segment records a CUDA event after its work (`PrefillTask.sync_token`)
so the Execution Pool can bound how far the host runs ahead of the card.
A prefill may resume over a cached prompt prefix (`start(prefix_len=P)`,
prefix sharing): the cache rows below P are seeded and the chunk loop
starts at operator offset P, so the kernel reads the seeded prefix.

With the tracer on (`repro_torch.tracing`), each step records a `segment`
span of its host time, with its operator (or the granularity's group),
layer and chunk, for the Execution Pool's task id it carries.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.model import (_check_ported, _merge_vision,
                                      _project_qkv, embed_tokens,
                                      layer_params, lm_head)

State = Dict[str, Any]

DENSE_OPS = ("qkv_proj", "attn", "o_proj", "gate_up_proj", "down_proj")
MOE_OPS = ("qkv_proj", "attn", "o_proj", "gate", "experts")


def op_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The operator set of a dense, vlm (a dense stack) or uniform MoE
    stack; raises for the other families (interleaved MoE pairs, ssm, the
    recurrent hybrid and audio), which the reference's segmented executor
    does not wire either."""
    _check_ported(cfg)
    if cfg.num_experts:
        if cfg.moe_layer_freq != 1:
            raise NotImplementedError(
                "segmented executor supports uniform MoE stacks (freq=1)")
        return MOE_OPS
    if cfg.family in ("dense", "vlm"):
        return DENSE_OPS
    raise NotImplementedError(
        f"segmented executor: family {cfg.family!r} not wired")


def mark(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream after the work enqueued so
    far, or None on the CPU (where every op has finished on return)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def wait(token: Optional[torch.cuda.Event]) -> None:
    """Block the host until the work before `token` has finished."""
    if token is not None:
        token.synchronize()


def stream_for(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A stream of a serving instance's own on the card; None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream: Optional[torch.cuda.Stream]):
    """Make `stream` current for this thread (a no-op on the CPU)."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Per-operator functions: fn(params, state, layer_idx, q_offset) -> state
# ---------------------------------------------------------------------------


def _make_op_fns(cfg: ModelConfig) -> Dict[str, Callable]:
    K, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads

    def qkv_proj(params, st, l, off):
        p = layer_params(params, l)
        x = L.rms_norm(st["h"], p["ln1"], cfg.norm_eps)
        return dict(st, tmp=_project_qkv(cfg, p, x))

    def attn(params, st, l, off):
        q, k, v = st["tmp"]
        B, Sc = q.shape[:2]
        positions = off + torch.arange(Sc, device=q.device)[None, :]
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        # the reference's functional dynamic_update_slice becomes an in-place
        # write: the (L, B, max_seq, K, hd) cache is preallocated by start()
        # and owned by this task alone
        kc, vc = st["k_cache"], st["v_cache"]
        kc[l, :, off:off + Sc] = k.to(kc.dtype)
        vc[l, :, off:off + Sc] = v.to(vc.dtype)
        out = kops.prefill_attention(
            q, kc[l], vc[l], q_offset=off, kv_len=off + Sc, causal=True,
            local_window=cfg.local_window)
        return dict(st, tmp=out.reshape(B, Sc, H * hd))

    def o_proj(params, st, l, off):
        p = layer_params(params, l)
        return dict(st, h=st["h"] + st["tmp"] @ p["wo"], tmp=None)

    def gate_up_proj(params, st, l, off):
        p = layer_params(params, l)
        x = L.rms_norm(st["h"], p["ln2"], cfg.norm_eps)
        return dict(st, tmp=L.gate_up(x, p["wi"]))

    def down_proj(params, st, l, off):
        p = layer_params(params, l)
        return dict(st, h=st["h"] + st["tmp"] @ p["wd"], tmp=None)

    def gate(params, st, l, off):
        p = layer_params(params, l)
        x = L.rms_norm(st["h"], p["ln2"], cfg.norm_eps)
        w, idx, _ = L.moe_router(x, p["router"], cfg.experts_per_token)
        return dict(st, tmp=(x, w, idx))

    def experts(params, st, l, off):
        p = layer_params(params, l)
        x, w, idx = st["tmp"]
        y = L.moe_apply(x, w, idx, p["wi"], p["wd"],
                        k=cfg.experts_per_token,
                        capacity_factor=cfg.moe_capacity_factor,
                        min_capacity=cfg.moe_min_capacity)
        return dict(st, h=st["h"] + y, tmp=None)

    return {"qkv_proj": qkv_proj, "attn": attn, "o_proj": o_proj,
            "gate_up_proj": gate_up_proj, "down_proj": down_proj,
            "gate": gate, "experts": experts}


# ---------------------------------------------------------------------------
# Execution plan + task
# ---------------------------------------------------------------------------


@dataclass
class PrefillTask:
    """A (possibly batched) prefill with device-resident state. The
    Execution Pool advances `cursor`; suspension is simply ceasing to step."""
    state: State
    prompt_len: int
    n_chunks: int
    chunk: int
    total_segments: int
    start_offset: int = 0
    cursor: int = 0
    logits: Optional[torch.Tensor] = None
    # event after the last stepped segment: the Execution Pool waits on it to
    # bound dispatch-ahead depth (None on the CPU)
    sync_token: Optional[torch.cuda.Event] = None
    # the Execution Pool's id of the task, which its `segment` spans name
    task_id: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.cursor >= self.total_segments

    @property
    def progress(self) -> float:
        return self.cursor / max(self.total_segments, 1)


class SegmentedPrefill:
    """Preemptible prefill executor for one model instance. Runs on the
    device that holds `params`.

    granularity: "op" (paper default) | "layer" | "block<k>" | "whole"
    chunk_tokens: 0 = no chunking (operator boundaries only), else chunked
                  prefill combined with operator preemption (paper Fig. 15).
    """

    def __init__(self, params, cfg: ModelConfig, *, max_seq: int,
                 granularity: str = "op", chunk_tokens: int = 0,
                 cache_dtype: torch.dtype = torch.float32):
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_seq = max_seq
        self.granularity = granularity
        self.chunk_tokens = chunk_tokens
        self.cache_dtype = cache_dtype
        self.ops = op_names(cfg)
        op_fns = _make_op_fns(cfg)

        per_layer = [op_fns[name] for name in self.ops]
        if granularity == "op":
            groups: List[List[Callable]] = [[f] for f in per_layer]
        elif granularity in ("layer", "whole") or granularity.startswith("block"):
            groups = [per_layer]
        else:
            raise ValueError(granularity)

        self._block_layers = 1
        if granularity.startswith("block"):
            self._block_layers = int(granularity[len("block"):] or 2)
        elif granularity == "whole":
            self._block_layers = cfg.num_layers

        def make_segment(fns, n_layers):
            def seg(params, st, l0, off):
                for l in range(l0, min(l0 + n_layers, cfg.num_layers)):
                    for f in fns:
                        st = f(params, st, l, off)
                return st
            return seg

        self._segments = [make_segment(g, self._block_layers) for g in groups]
        # what a `segment` span calls each group: its operator, or the
        # granularity where one group runs every operator of its layers
        self._segment_names = list(self.ops) if granularity == "op" \
            else [granularity]
        self._segments_per_chunk = (
            (cfg.num_layers + self._block_layers - 1) // self._block_layers
            * len(self._segments))

    # --- plan geometry -------------------------------------------------------
    def n_chunks(self, prompt_len: int, prefix_len: int = 0) -> int:
        todo = prompt_len - prefix_len
        if not self.chunk_tokens:
            return 1
        return (todo + self.chunk_tokens - 1) // self.chunk_tokens

    def segments_for(self, prompt_len: int, prefix_len: int = 0) -> int:
        return self.n_chunks(prompt_len, prefix_len) \
            * self._segments_per_chunk + 1                          # +head

    # --- lifecycle -------------------------------------------------------------
    def start(self, tokens, lens=None, prefix_len: int = 0, prefix_k=None,
              prefix_v=None, *, vision_embeds=None) -> PrefillTask:
        """Begin a prefill of `tokens` (B, S), padded rows of true lengths
        `lens` (default S each). Allocates the task's (L, B, max_seq, K, hd)
        KV cache on the current stream.

        ``prefix_len > 0`` resumes over a cached prompt prefix: `prefix_k` /
        `prefix_v` (L, B, prefix_len, K, hd) seed the first positions of the
        cache (cast to `cache_dtype`, on the current stream) and the chunk
        loop starts at operator offset `prefix_len` — suffix-only compute.
        Requires prefix_len < S: the last token's logits need a live pass.

        `vision_embeds` (B, P, D), a vlm's patch embeddings, stay in the
        task's state and replace the first P positions of chunk 0's
        embeddings, as in the reference; P may not exceed the first chunk.
        A resume over a cached prefix recomputes no vision span, so the two
        together raise (the reference never combines them)."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        B, S = tokens.shape
        cfgc = self.cfg
        K, hd = cfgc.num_kv_heads, cfgc.resolved_head_dim
        chunk = self.chunk_tokens or (S - prefix_len)
        if vision_embeds is not None:
            if prefix_len:
                raise ValueError("prefix resumption over vision embeds is "
                                 "not supported (recompute the vision span)")
            vision_embeds = torch.as_tensor(vision_embeds, device=self.device)
            if vision_embeds.shape[1] > min(chunk, S):
                raise ValueError(
                    f"{vision_embeds.shape[1]} patch embeddings do not fit "
                    f"the first chunk of {min(chunk, S)} tokens")
        shape = (cfgc.num_layers, B, self.max_seq, K, hd)
        kc = torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
        vc = torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
        if prefix_len:
            if prefix_len >= S:
                raise ValueError(f"prefix_len={prefix_len} must leave at "
                                 f"least one live token (prompt {S})")
            kc[:, :, :prefix_len] = prefix_k
            vc[:, :, :prefix_len] = prefix_v
        state: State = {
            "tokens": tokens,
            # host ints: the head and the KV handoff index rows with them
            "lens": [S] * B if lens is None else [int(n) for n in lens],
            "h": None,                    # set per chunk
            "tmp": None,
            "k_cache": kc,
            "v_cache": vc,
            "h_full": torch.zeros((B, S, cfgc.d_model), dtype=torch.float32,
                                  device=self.device),
        }
        if vision_embeds is not None:
            state["vision_embeds"] = vision_embeds
        return PrefillTask(state=state, prompt_len=S, start_offset=prefix_len,
                           n_chunks=self.n_chunks(S, prefix_len), chunk=chunk,
                           total_segments=self.segments_for(S, prefix_len))

    def _chunk_bounds(self, task: PrefillTask, chunk_idx: int) -> Tuple[int, int]:
        lo = task.start_offset + chunk_idx * task.chunk
        hi = min(lo + task.chunk, task.prompt_len)
        return lo, hi

    def _head(self, h_full: torch.Tensor, lens) -> torch.Tensor:
        # per-request last valid position (batched requests are padded)
        B = h_full.shape[0]
        rows = torch.arange(B, device=h_full.device)
        last = torch.as_tensor(lens, device=h_full.device) - 1
        return lm_head(self.cfg, self.params, h_full[rows, last][:, None, :])[:, 0]

    def step(self, task: PrefillTask) -> bool:
        """Run the next segment. Returns True when the task completed. This
        is the paper's operator boundary: the caller checks the preemption
        signal between calls."""
        if task.done:
            return True
        tr = tracing.on
        if tr:
            t0 = time.monotonic()
        seg_idx = task.cursor
        spc = self._segments_per_chunk
        if seg_idx == task.total_segments - 1:              # lm_head
            task.logits = self._head(task.state["h_full"], task.state["lens"])
            task.sync_token = mark(self.device)
            task.cursor += 1
            if tr:
                tracing.record("segment", t0, time.monotonic(),
                               cause=task.task_id, op="head", layer=None,
                               chunk=None)
            return True

        chunk_idx, within = divmod(seg_idx, spc)
        lo, hi = self._chunk_bounds(task, chunk_idx)
        layer_block, group_idx = divmod(within, len(self._segments))
        l0 = layer_block * self._block_layers

        st = task.state
        if within == 0:                                     # chunk begins
            h = embed_tokens(self.cfg, self.params, st["tokens"][:, lo:hi])
            if chunk_idx == 0 and "vision_embeds" in st:
                h = _merge_vision(h, st["vision_embeds"])
            st = dict(st, h=h)
        st = self._segments[group_idx](self.params, st, l0, lo)
        if within == spc - 1:                               # chunk ends
            st["h_full"][:, lo:hi] = st["h"].to(st["h_full"].dtype)
        task.state = st
        task.sync_token = mark(self.device)
        task.cursor += 1
        if tr:
            tracing.record("segment", t0, time.monotonic(), cause=task.task_id,
                           op=self._segment_names[group_idx], layer=l0,
                           chunk=chunk_idx)
        return task.done

    def run_all(self, task: PrefillTask) -> torch.Tensor:
        """Uninterrupted execution (baseline / tests)."""
        while not task.done:
            self.step(task)
        return task.logits
