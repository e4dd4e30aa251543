"""Transfer benchmarks of the tuner — so far only the canonical source
trace that serving-stack tuning observes.  The kernel-launch and serving
sweeps, their regret gate and the sim-to-real sweep come in a later
slice."""

#: the calm-Poisson trace serving tuning observes as its cheap source
DEFAULT_SOURCE_TRACE = "poisson:rate=2500"
