"""Frozen copy of the simulator's host layer, taken when the benchmark was
defined: constants, gnss_time, rinex, geodesy, iono, observables, codes,
inav, fec2, channels, scenario and models/, with the raw ICD code tables
and NeQuick coefficients in data/.  It is the reference's scenario: the
program's own copy may change, this one does not.
"""
