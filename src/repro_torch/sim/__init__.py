"""The discrete-event simulator: the analytic prefill and decode cost
models, the single-instance `PrefillSim`, the multi-instance `ClusterSim`
and the scheduling policies. Verbatim copies of src/repro/sim/ (imports
rewritten), and `hardware.H100`, the card the port runs on."""
