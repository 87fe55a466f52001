"""Analysis of the port's steps: `cost`, the FLOP and byte counter of an
eager step and its roofline terms (the counterpart of the JAX package's
`repro.analysis.hlo`)."""
