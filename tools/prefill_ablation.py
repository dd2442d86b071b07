"""Locate the bottleneck of the prefill kernel's tensor-core body on the card.

Builds `src/repro_torch/kernels/csrc/flash_prefill.cu` as it is and a few
ablated copies of it (each drops one part of the work, so its output is
wrong and only its time counts), and times each at the Llama3-8B main-path
shapes beside one `F.scaled_dot_product_attention` call:

  full        the kernel as shipped (checked against the plain version)
  no_load     the producer loads only the first ring of K/V tiles, then
              hands the stages back without copying
  no_softmax  the tile loop feeds the raw scores to P V (no mask, max, exp,
              sum or rescale)
  no_exp      the exp2 becomes a multiply
  one_p       P as one bf16 term (the P_lo products dropped)

    python3 tools/prefill_ablation.py            # needs a CUDA card and nvcc
    python3 tools/prefill_ablation.py full one_p # a subset

Prints the card's name and power limit, then one line per build with ptxas's
registers and spills and the time in ms of each shape (CUDA events around 50
calls queued behind a spin of the card, after 5 warm-up calls). Copies are
built under build/ablation/ (git-ignored).
"""
from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/ablation"
SHAPES = [  # label, Sq, q_offset, kv_len (H 32, K 8, hd 128, T 4096)
    ("chunk512@0", 512, 0, 512),
    ("chunk512@3584", 512, 3584, 4096),
    ("tail100@2048", 100, 2048, 2148),
]


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"ablation out of date: {old.strip()[:60]!r} "
                         f"occurs {src.count(old)} times in the kernel")
    return src.replace(old, new)


ABLATIONS = {
    "full": lambda s: s,
    "no_load": lambda s: _swap(
        s, "        mbar_arrive_expect_tx(&sm.full[s], BK * (QK + VD) * 2);\n",
        "        if (t >= NS) { mbar_arrive(&sm.full[s]); continue; }\n"
        "        mbar_arrive_expect_tx(&sm.full[s], BK * (QK + VD) * 2);\n"),
    "no_softmax": lambda s: _swap(
        _swap(s, "    softmax(k_begin + t * BK);\n",
              "    alpha[0] = alpha[1] = 1.f;\n"),
        "    softmax(k_begin);\n", "    alpha[0] = alpha[1] = 1.f;\n"),
    "no_exp": lambda s: _swap(
        s, "x = ex2(fmaf(x, scale_log2, -m_new));",
        "x = fmaf(x, scale_log2, -m_new) * 1e-3f;"),
    "one_p": lambda s: _swap(s, "      pv_mma<VD>(acc, p_lo[kk], dv);\n", ""),
}


def build_all(names, build):
    """Compile every ablation in parallel; returns {name: (lib, ptxas line)}."""
    base = (CSRC / "flash_prefill.cu").read_text()
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "flash_prefill.cu").write_text(ABLATIONS[name](base))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(d / "lib.so"), str(d / "flash_prefill.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn, report = None, []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and "prefill_tc_kernelILi128E" in fn and (
                    "spill stores" in line or "Used" in line):
                report.append(line.split(":", 1)[-1].strip())
        libs[name] = (ctypes.CDLL(str(OUT / name / "lib.so")),
                      "; ".join(report))
    return libs


def main() -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, ref
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    names = sys.argv[1:] or list(ABLATIONS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    libs = build_all(names, build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, K, hd, T = 32, 8, 128, 4096
    inputs = [(label, *(torch.randn(shape, generator=gen, device=dev)
                        .to(torch.bfloat16) for shape in
                        ((1, Sq, H, hd), (1, T, K, hd), (1, T, K, hd))),
               qoff, kv_len) for label, Sq, qoff, kv_len in SHAPES]

    def ms(fn, iters=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # queue every call before the first
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in names:
        lib, report = libs[name]
        fn = lib.flash_prefill_attention
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, L, L, L, L, L, L,
                       L, L, I, I, I, I, ctypes.c_float, P,
                       ctypes.POINTER(I)]

        def call(q, k, v, qoff, kv_len, fn=fn):
            out = torch.empty_like(q)
            tc = ctypes.c_int(0)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     1, 1, q.shape[1], T, H, K, hd, hd, q.stride(0),
                     q.stride(1),
                     k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                     out.stride(0), out.stride(1), qoff, kv_len, 1, 0,
                     1 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream,
                     ctypes.byref(tc))
            if err or not tc.value:
                raise SystemExit(f"{name}: launch error {err}")
            return out

        times = []
        for label, q, k, v, qoff, kv_len in inputs:
            if name == "full":
                want = ref.chunked_prefill_attention_ref(
                    q, k, v, q_offset=qoff, kv_len=kv_len).float()
                got = call(q, k, v, qoff, kv_len).float()
                worst = ((got - want).abs()
                         / (1e-5 + 1.6e-2 * want.abs())).max().item()
                label += f" (worst/limit {worst:.3f})"
            times.append(f"{label} {ms(lambda: call(q, k, v, qoff, kv_len)):.4f}")
        print(f"{name:<11} {report}\n            " + "  ".join(times),
              flush=True)
    sdpa = []
    for label, q, k, v, qoff, kv_len in inputs:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kpos = torch.arange(T, device=dev)[None, :]
        mask = (kpos <= qoff + torch.arange(q.shape[1], device=dev)[:, None]) \
            & (kpos < kv_len)
        t = ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        sdpa.append(f"{label} {t:.4f}")
    print("sdpa        " + "  ".join(sdpa))


if __name__ == "__main__":
    main()
