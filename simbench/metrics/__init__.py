"""Per-layer metric readers, one file each, found by the metric's name in
BENCHMARK.json: `<name>.py` defines `read(readings)`, which returns the
metric's value or None when the run gave it nothing to read (the harness
then leaves the metric out of the result line). The other modules here
hold the arithmetic the readers share."""
