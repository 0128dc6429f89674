"""Evaluation of the port (``svtpu/evaluation``): model bundles, state
consistency under perturbations, adjacent-state Hamming separation, symbol
bit-match, the consistency/separation trade-off, projections and the
linear probe. Charts need matplotlib and the projections and the probe
sklearn; each module imports them only where they are used."""
