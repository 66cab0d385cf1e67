"""Seeded generators of the benchmark's inputs: corpora and query pools
(one module per generator, named by a configuration's ``generator``) and
arrival schedules (:mod:`gpubench.gen.arrivals`)."""
