"""The share in % of the program's `segment` spans (one operator segment
of `SegmentedPrefill.step`) replayed from CUDA graphs: those whose
`graphed` attribute is True, of those that carry it. None where no span
carries it (a program without graphed segments)."""
from harness import spans


def read(run):
    got = spans.of(run)
    if got is None:
        return None
    flags = [s.attrs["graphed"] for s in spans.named(got, "segment")
             if "graphed" in s.attrs]
    return 100.0 * sum(map(bool, flags)) / len(flags) if flags else None
