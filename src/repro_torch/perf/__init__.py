"""Performance analysis: the op record's static cost model + roofline derivation."""
