"""Set-up time: from the start of the process to the window's opening,
taking in the weights drawn on the device, the offline TTFT profile (which
warms every shape of the prefill path) and, on a checkout's first run, the
build of the CUDA kernels."""


def read(run):
    return run.setup_s
