"""The plain reference of the benchmark: what a file of Galileo E1 signal
should hold, worked out again from the nav file and the job's scene.

`hostlayer/` is a frozen copy of the simulator's float64 host layer (nav
parser, orbits, observables, I/NAV pages, channel allocation, scenario
stepping, signal models and their raw ICD tables), and `synth.py` sums the
channels sample by sample in float64 and filters the band-limited stream
with the published 385-tap filter.  Nothing here imports the program under
test, JAX or the JAX package.
"""
