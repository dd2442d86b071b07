"""Operator-segmented prefill: FlowPrefill's operator-level preemption
(§5.1, Fig. 6) on eager PyTorch.

Counterpart of src/repro/models/segments.py. The prefill runs as a sequence
of segments, each one or more operators over buffers that live on the
device; the host checks the preemption flag between segments, and a
suspended task is simply one that is not stepped (its state stays on the
device, nothing is recomputed on resume).

Operator sets (paper §5.1 / §6.5):
    dense:  qkv_proj | attn | o_proj | gate_up_proj | down_proj
    moe:    qkv_proj | attn | o_proj | gate | experts
A vlm runs the dense set; its patch embeddings replace the leading
positions of chunk 0 (`start(..., vision_embeds=)`). A latent-attention
stack (`MLAConfig`) runs the dense set at its leading dense layers and the
MoE set after them (`layer_op_names`). There `qkv_proj` projects q and the
latent (c_kv normed, q's and k_pe's rotary dims rotated), `attn` writes the
chunk's latent into the task's cache, up-projects the visible rows [0,
q_offset + Sc) to per-head keys and values and runs the prefill kernel on
them, and `gate` also adds the shared experts. Boundary granularity
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

Every operator has one body, over (rows, width) buffers of the chunk's
flattened B * Sc tokens: the hidden state, the operators' outputs and the
chunk's RoPE tables, built once at the chunk's start and applied at the
end of `qkv_proj`. The executor holds one set at its largest token-count
bucket (`token_buckets`); a task stepped while another is resident first
spills the other's live rows into that task's state and loads its own. A
task whose chunk holds more tokens than the largest bucket runs over
buffers of its own, allocated with it at its row count, and never claims
the executor's. On the card the per-token operators (`GRAPHED_OPS`: every
row is computed alone, so padded rows change no valid one) over the
executor's buffers are replayed from CUDA graphs, one per layer, operator
and bucket, all captured when the executor is built so no capture stalls
a serving step; `attn` (the kernel's offsets and lengths are per task and
chunk) and `experts` run uncaptured over the same buffers. On the card
`experts` is the grouped kernel of `moe_apply`, which makes no host sync
and sizes every grid from the token count, so it could be captured too;
capturing it is left for later. On the CPU, and above the largest bucket,
each operator's body is called over the buffers at the chunk's row count.

With the tracer on (`repro_torch.tracing`), each step records a `segment`
span of its host time, with its operator (or the granularity's group),
layer and chunk, whether it replayed graphs (`graphed`), for the
Execution Pool's task id it carries; a latent-attention step that ran
`attn` also the latent rows it up-projected (`kv_rows`) and its query rows
(`q_rows`). `kernels.counts` counts the steps that replayed graphs, the
eager ones and the graphs captured (`GRAPH_COUNTS`), and the latent rows
up-projected (`mla_kv_rows`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import counts
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.model import (_check_ported, _merge_vision,
                                      _project_qkv, cache_shapes,
                                      embed_tokens, is_mla, layer_params,
                                      lm_head, mla_expand, mla_project,
                                      rope_dim)

State = Dict[str, Any]

DENSE_OPS = ("qkv_proj", "attn", "o_proj", "gate_up_proj", "down_proj")
MOE_OPS = ("qkv_proj", "attn", "o_proj", "gate", "experts")
# the per-token operators, replayed from CUDA graphs on the card
GRAPHED_OPS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj", "gate")
# steps that replayed graphs, steps that ran eagerly, graphs captured
GRAPH_COUNTS = ("segment_graph_replay", "segment_eager",
                "segment_graph_capture")
# the buffers live before each operator, besides h and the tables
_LIVE = {"attn": ("q", "k", "v"), "o_proj": ("o",), "down_proj": ("gu",),
         "experts": ("x", "w", "idx")}


def op_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The operator set of a dense, vlm (a dense stack) or uniform MoE
    stack (of a latent-attention stack: that of its MoE layers); raises for
    the other families (interleaved MoE pairs, ssm, the recurrent hybrid
    and audio), which the reference's segmented executor does not wire
    either."""
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


def layer_op_names(cfg: ModelConfig) -> List[Tuple[str, ...]]:
    """Each layer's operator set: `op_names` everywhere but at a
    latent-attention stack's leading dense layers, which run the dense
    set."""
    ops = op_names(cfg)
    n_dense = cfg.first_k_dense if is_mla(cfg) else 0
    return [DENSE_OPS if l < n_dense else ops
            for l in range(cfg.num_layers)]


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


def token_buckets(largest: int) -> List[int]:
    """The token counts the executor's buffers run at, up to the first at or
    above `largest`: powers of two from 16 to 1024, then steps of 1.5x and
    4/3x (1536, 2048, 3072, 4096, ...). A chunk's count pads up to the
    next one: at most 2x below 1024 tokens, 1.5x above."""
    out = [16]
    while out[-1] < largest:
        b = out[-1]
        out.append(2 * b if b < 1024 else
                   b * 3 // 2 if b & (b - 1) == 0 else b * 4 // 3)
    return out


def _graphable(device: torch.device) -> bool:
    """Whether the per-token operators replay CUDA graphs: on the
    card."""
    return device.type == "cuda"


def _capture(fn: Callable[[], None], stream, pool) -> Callable[[], None]:
    """`fn`'s launches captured on `stream` into a CUDA graph whose
    temporaries come from `pool`; returns its replay, which launches on
    the current stream. Other threads may launch meanwhile."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    return graph.replay


def _make_op_fns(cfg: ModelConfig) -> Dict[str, Callable]:
    """The per-token operators over the executor's buffers: fn(p, buf, n)
    reads and writes the leading n rows of each (rows, width) buffer of
    `buf`, the chunk's tokens flattened, with layer params `p`. `attn`'s
    RoPE runs at the end of `qkv_proj`, from the chunk's tables."""
    K, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads

    def qkv_proj(p, buf, n):
        x = L.rms_norm(buf["h"][:n], p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p, x)
        cos, sin = buf["cos"][:n, None], buf["sin"][:n, None]
        L.rope_rotate(q, cos, sin, out=buf["q"][:n].view(n, H, hd))
        L.rope_rotate(k, cos, sin, out=buf["k"][:n].view(n, K, hd))
        buf["v"][:n].copy_(v.flatten(1))

    def o_proj(p, buf, n):
        buf["h"][:n].add_(buf["o"][:n] @ p["wo"])

    def gate_up_proj(p, buf, n):
        x = L.rms_norm(buf["h"][:n], p["ln2"], cfg.norm_eps)
        L._gate_up(x, p["wi"], out=buf["gu"][:n])

    def down_proj(p, buf, n):
        buf["h"][:n].add_(buf["gu"][:n] @ p["wd"])

    def gate(p, buf, n):
        x = L.rms_norm(buf["h"][:n], p["ln2"], cfg.norm_eps)
        w, idx, _ = L.moe_router(x, p["router"], cfg.experts_per_token)
        buf["x"][:n].copy_(x)
        buf["w"][:n].copy_(w)
        buf["idx"][:n].copy_(idx)

    def mla_qkv_proj(p, buf, n):
        x = L.rms_norm(buf["h"][:n], p["ln1"], cfg.norm_eps)
        q, c, k_pe = mla_project(cfg, p, x, buf["cos"][:n], buf["sin"][:n])
        buf["q"][:n].copy_(q.flatten(1))
        buf["k"][:n].copy_(c)
        buf["v"][:n].copy_(k_pe)

    def mla_gate(p, buf, n):
        x = L.rms_norm(buf["h"][:n], p["ln2"], cfg.norm_eps)
        w, idx, _ = L.moe_router_sigmoid(x, p["router"], p["router_bias"],
                                         cfg.experts_per_token,
                                         cfg.routed_scaling_factor)
        buf["x"][:n].copy_(x)
        buf["w"][:n].copy_(w)
        buf["idx"][:n].copy_(idx)
        buf["h"][:n].add_(L.swiglu(x, p["wi_shared"], p["wd_shared"]))

    if is_mla(cfg):
        qkv_proj, gate = mla_qkv_proj, mla_gate
    return {"qkv_proj": qkv_proj, "o_proj": o_proj,
            "gate_up_proj": gate_up_proj, "down_proj": down_proj,
            "gate": gate}


# ---------------------------------------------------------------------------
# Execution plan + task
# ---------------------------------------------------------------------------


@dataclass
class PrefillTask:
    """A (possibly batched) prefill with device-resident state. The
    Execution Pool advances `cursor`; suspension is simply ceasing to step.
    `state` holds the prompt (`tokens`, `lens`), the task's KV cache
    (`k_cache`, `v_cache`) and the final hidden state `h_full`; a task
    whose chunk holds more tokens than the executor's largest bucket also
    buffers of its own (`buf`), and a task whose live rows another task's
    step displaced from the executor's buffers their copies (`spill`)."""
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
        # each layer's operators: the same number at every layer, so a
        # segment runs the same slots of each layer's set
        self._layer_ops = layer_op_names(cfg)
        self._mla = is_mla(cfg)

        slots = tuple(range(len(self.ops)))
        if granularity == "op":
            segs: List[Tuple[int, ...]] = [(i,) for i in slots]
        elif granularity in ("layer", "whole") or granularity.startswith("block"):
            segs = [slots]
        else:
            raise ValueError(granularity)

        self._block_layers = 1
        if granularity.startswith("block"):
            self._block_layers = int(granularity[len("block"):] or 2)
        elif granularity == "whole":
            self._block_layers = cfg.num_layers

        # the slots of each layer's operators each segment of a block runs
        self._segments = segs
        self._segments_per_chunk = (
            (cfg.num_layers + self._block_layers - 1) // self._block_layers
            * len(self._segments))
        self._fns = _make_op_fns(cfg)
        # the buffers at the largest bucket (8 chunks, for batched rows; the
        # whole prompt where there is no chunking)
        self._buckets = token_buckets(8 * chunk_tokens or max_seq)
        self._buf = self._buffers(self._buckets[-1])
        # the task whose live tensors the buffers hold, and the stream and
        # event of the buffers' last step
        self._resident: Optional[weakref.ref] = None
        self._last: Optional[Tuple[torch.cuda.Stream, torch.cuda.Event]] = None
        self._lock = threading.Lock()
        self._graphs: Dict[Tuple[int, str, int], Callable[[], None]] = {}
        if _graphable(self.device):
            self._capture_graphs()

    # --- buffers and graphs ----------------------------------------------------
    def _buffers(self, rows: int) -> Dict[str, torch.Tensor]:
        """The (rows, width) buffers a chunk's operators read and write: the
        hidden state `h`, the chunk's RoPE tables, q, the two cache rows
        (k/v; a latent stack's c_kv/k_pe), attn's output `o`, and the
        routing (`x`, `w`, `idx`) or the gated product `gu`."""
        cfg = self.cfg
        K, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
        act = self.params["embed"].dtype

        def zeros(width, dtype=act):
            return torch.zeros((rows, width), dtype=dtype, device=self.device)
        widths = (H * cfg.qk_head_dim, cfg.kv_lora_rank,
                  cfg.qk_rope_head_dim, H * cfg.v_head_dim) if self._mla \
            else (H * hd, K * hd, K * hd, H * hd)
        half = rope_dim(cfg) // 2
        buf = {"h": zeros(cfg.d_model), "cos": zeros(half, torch.float32),
               "sin": zeros(half, torch.float32)}
        buf.update(zip(("q", "k", "v", "o"), map(zeros, widths)))
        names = {n for ops in self._layer_ops for n in ops}
        if "gate" in names:
            k = cfg.experts_per_token
            buf.update(x=zeros(cfg.d_model), w=zeros(k, torch.float32),
                       idx=zeros(k, torch.int64))
        if "gate_up_proj" in names:
            buf["gu"] = zeros(self.params["layers"][
                "wi_dense" if self._mla else "wi"].shape[-1])
        return buf

    def _capture_graphs(self) -> None:
        """The graphs of every per-token operator at every layer and bucket,
        captured before any task runs. Each operator runs once at each
        bucket on the capture stream first, which sets up the cuBLAS handle
        and workspace of this thread and stream and loads the bucket's
        kernels outside the capture."""
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        pool = torch.cuda.graph_pool_handle() if cuda else None
        if stream is not None:                  # the buffers' zeros first
            stream.wait_stream(torch.cuda.current_stream(self.device))
        # every per-token operator some layer runs, in a layer's order
        names = [n for n in dict.fromkeys(n for ops in self._layer_ops
                                          for n in ops) if n in GRAPHED_OPS]
        for b in self._buckets:
            for name in names:
                at = [l for l, ops in enumerate(self._layer_ops)
                      if name in ops]
                with on_stream(stream):
                    self._fns[name](layer_params(self.params, at[0]),
                                    self._buf, b)
                if stream is not None:
                    stream.synchronize()
                for l in at:
                    self._graphs[l, name, b] = _capture(functools.partial(
                        self._fns[name], layer_params(self.params, l),
                        self._buf, b), stream, pool)
                    counts.bump("segment_graph_capture")

    def _live(self, task: PrefillTask) -> Tuple[int, Tuple[str, ...]]:
        """The rows and the names of the buffers `task` holds live before
        its next segment: none at a chunk's start."""
        chunk_idx, within = divmod(task.cursor, self._segments_per_chunk)
        if within == 0 or task.done:
            return 0, ()
        lo, hi = self._chunk_bounds(task, chunk_idx)
        block, seg = divmod(within, len(self._segments))
        nxt = self._layer_ops[block * self._block_layers][
            self._segments[seg][0]]
        return (task.state["tokens"].shape[0] * (hi - lo),
                ("h", "cos", "sin") + _LIVE.get(nxt, ()))

    def _claim(self, task: PrefillTask) -> None:
        """Make the executor's buffers `task`'s: after the buffers' last
        step where that ran on another stream, spill the resident task's
        live tensors into its state, and load `task`'s."""
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        if self._last is not None and self._last[0] != stream:
            stream.wait_event(self._last[1])
        old = self._resident() if self._resident is not None else None
        if old is task:
            return
        if old is not None:
            n, names = self._live(old)
            if names:
                old.state["spill"] = {k: self._buf[k][:n].clone()
                                      for k in names}
        for k, t in task.state.pop("spill", {}).items():
            self._buf[k][:t.shape[0]].copy_(t)
            if stream is not None:
                t.record_stream(stream)
        self._resident = weakref.ref(task)

    def _buf_of(self, task: PrefillTask) -> Dict[str, torch.Tensor]:
        """The buffers `task`'s operators run over: its own, else the
        executor's."""
        return task.state.get("buf", self._buf)

    def _attn(self, task: PrefillTask, l: int, off: int, B: int, Sc: int):
        """`attn` over the buffers: the chunk's k/v (a latent stack's
        c_kv/k_pe) into the task's cache, then the prefill kernel writing
        the buffer `o_proj` reads. A latent stack first up-projects the
        cache's rows [0, off + Sc) to per-head keys and values."""
        cfg, buf, n, T = self.cfg, self._buf_of(task), B * Sc, off + Sc
        kc, vc = task.state["k_cache"][l], task.state["v_cache"][l]
        kc[:, off:T] = buf["k"][:n].view(B, Sc, *kc.shape[2:])
        vc[:, off:T] = buf["v"][:n].view(B, Sc, *vc.shape[2:])
        k, v = kc, vc
        if self._mla:
            k, v = mla_expand(cfg, layer_params(self.params, l),
                              kc[:, :T, 0], vc[:, :T, 0])
            counts.bump("mla_kv_rows", B * T)
        H = cfg.num_heads
        kops.prefill_attention(
            buf["q"][:n].view(B, Sc, H, -1), k, v, q_offset=off, kv_len=T,
            causal=True, local_window=cfg.local_window,
            out=buf["o"][:n].view(B, Sc, H, -1))

    def _experts(self, task: PrefillTask, l: int, off: int, B: int, Sc: int):
        """`experts` over the buffers, on the chunk's B * Sc tokens, added
        into h in place (on the card by the kernel's combine)."""
        cfg, buf, n = self.cfg, self._buf_of(task), B * Sc
        p = layer_params(self.params, l)
        L.moe_apply(buf["x"][:n].view(B, Sc, -1),
                    buf["w"][:n].view(B, Sc, -1),
                    buf["idx"][:n].view(B, Sc, -1), p["wi"], p["wd"],
                    k=cfg.experts_per_token,
                    capacity_factor=cfg.moe_capacity_factor,
                    min_capacity=cfg.moe_min_capacity, residual=buf["h"][:n])

    def _run(self, task: PrefillTask, chunk_idx: int, within: int,
             seg: int, l0: int) -> bool:
        """One segment over the task's buffers; True where it replayed
        graphs."""
        cfg, st = self.cfg, task.state
        lo, hi = self._chunk_bounds(task, chunk_idx)
        B, Sc = st["tokens"].shape[0], hi - lo
        n = B * Sc
        buf, bucket = st.get("buf"), None       # its own buffers: no graphs
        if buf is None:
            buf = self._buf
            self._claim(task)
            bucket = next(b for b in self._buckets if b >= n)
        if within == 0:                                     # chunk begins
            h = embed_tokens(cfg, self.params, st["tokens"][:, lo:hi])
            if chunk_idx == 0 and "vision_embeds" in st:
                h = _merge_vision(h, st["vision_embeds"])
            buf["h"][:n].copy_(h.reshape(n, -1))
            cos, sin = L.rope_tables(
                lo + torch.arange(Sc, device=self.device), rope_dim(cfg),
                cfg.rope_theta)
            buf["cos"][:n].view(B, Sc, -1).copy_(cos)
            buf["sin"][:n].view(B, Sc, -1).copy_(sin)
        graphed = False
        for l in range(l0, min(l0 + self._block_layers, cfg.num_layers)):
            for i in self._segments[seg]:
                name = self._layer_ops[l][i]
                if name == "attn":
                    self._attn(task, l, lo, B, Sc)
                elif name == "experts":
                    self._experts(task, l, lo, B, Sc)
                elif (l, name, bucket) in self._graphs:
                    self._graphs[l, name, bucket]()
                    graphed = True
                else:
                    self._fns[name](layer_params(self.params, l), buf, n)
        if within == self._segments_per_chunk - 1:          # chunk ends
            st["h_full"][:, lo:hi] = buf["h"][:n].view(B, Sc, -1).to(
                st["h_full"].dtype)
        task.sync_token = mark(self.device)
        if task.sync_token is not None and buf is self._buf:
            self._last = (torch.cuda.current_stream(self.device),
                          task.sync_token)
        return graphed

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
        KV cache (a latent-attention stack's latent, `cache_shapes`) on the
        current stream, and where a chunk's B * Sc tokens exceed the largest
        bucket, buffers of the task's own at that row count.

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
        shapes = cache_shapes(cfgc, B, self.max_seq, self.cache_dtype)
        kc, vc = (torch.zeros(shapes[key][0], dtype=self.cache_dtype,
                              device=self.device) for key in ("k", "v"))
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
            "k_cache": kc,
            "v_cache": vc,
            "h_full": torch.zeros((B, S, cfgc.d_model), dtype=torch.float32,
                                  device=self.device),
        }
        if vision_embeds is not None:
            state["vision_embeds"] = vision_embeds
        rows = B * min(chunk, S - prefix_len)
        if rows > self._buckets[-1]:
            state["buf"] = self._buffers(rows)
        return PrefillTask(
            state=state, prompt_len=S, start_offset=prefix_len,
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
        if seg_idx == task.total_segments - 1:              # lm_head
            task.logits = self._head(task.state["h_full"], task.state["lens"])
            task.sync_token = mark(self.device)
            task.cursor += 1
            counts.bump("segment_eager")
            if tr:
                tracing.record("segment", t0, time.monotonic(),
                               cause=task.task_id, op="head", layer=None,
                               chunk=None, graphed=False)
            return True

        chunk_idx, within = divmod(seg_idx, self._segments_per_chunk)
        layer_block, seg = divmod(within, len(self._segments))
        l0 = layer_block * self._block_layers
        # the cursor moves under the lock too: the next claim reads from it
        # what this task holds live in the executor's buffers
        with self._lock:
            graphed = self._run(task, chunk_idx, within, seg, l0)
            task.cursor += 1
        counts.bump("segment_graph_replay" if graphed else "segment_eager")
        if tr:
            # an operator's name, or the granularity where one segment runs
            # every operator of its layers
            op = self._layer_ops[l0][self._segments[seg][0]] \
                if self.granularity == "op" else self.granularity
            rows = self._latent_rows(task, chunk_idx, seg, l0) \
                if self._mla else {}
            tracing.record("segment", t0, time.monotonic(), cause=task.task_id,
                           op=op, layer=l0, chunk=chunk_idx, graphed=graphed,
                           **rows)
        return task.done

    def _latent_rows(self, task: PrefillTask, chunk_idx: int,
                     seg: int, l0: int) -> Dict[str, int]:
        """A latent-attention step's span rows: the latent rows its `attn`
        operators up-projected and their query rows (none without one)."""
        n_attn = sum(self._layer_ops[l][i] == "attn" for l in range(
            l0, min(l0 + self._block_layers, self.cfg.num_layers))
            for i in self._segments[seg])
        if not n_attn:
            return {}
        lo, hi = self._chunk_bounds(task, chunk_idx)
        B = task.state["tokens"].shape[0] * n_attn
        return dict(kv_rows=B * hi, q_rows=B * (hi - lo))

    def run_all(self, task: PrefillTask) -> torch.Tensor:
        """Uninterrupted execution (baseline / tests)."""
        while not task.done:
            self.step(task)
        return task.logits
