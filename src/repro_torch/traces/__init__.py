"""Synthetic request traces: the paper's Qwen trace tables and the stress
scenarios. Verbatim copies of src/repro/traces/ (imports rewritten)."""
