"""The NVIDIA H100 as a simulator `HardwareSpec`.

The port runs on an H100 SXM5 80 GB. Its peaks are NVIDIA's data sheet,
the same bounds the kernels' roofline in PERF.md uses: 989 TFLOP/s of
dense bf16 on the tensor cores and 3.35 TB/s of HBM3. Every other field
keeps the dataclass's default (the achievable fractions, launch overhead,
saturation, host and disk links), as the reference's A100 and A800 do.
`costmodel.resolve_hardware` accepts the instance, so every simulator entry
point takes it as it is. It lives here and not in the copied
`costmodel.py`, which stays the reference's file.
"""
from repro_torch.sim.costmodel import HardwareSpec

H100 = HardwareSpec("H100-SXM5-80G", peak_flops=989e12, hbm_bw=3.35e12)
