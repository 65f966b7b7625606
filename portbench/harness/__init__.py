"""The benchmark's general code: cells found by name (spec), jobs drawn
from the seed (jobs), the window (window), the trace's reduction (trace),
the peaks and work counts (roofline), the comparison with the plain
reference (check) and the run itself (main)."""
