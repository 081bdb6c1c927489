"""Distributed training substrate, ported from ``repro/distributed``:
placement rules, activation annotations, the sharded train step, int8
gradient compression, elastic remesh and the GPipe pipeline."""
