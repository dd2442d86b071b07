"""Logical-axis sharding on a `DeviceMesh` (DTensor placements) and the
collective-traffic accounting. Counterpart of src/repro/distributed/."""
