"""The plain reference of the benchmark: the FX correlator's function in
float64 PyTorch, its delay calibration and the product CSV's row parser,
with the judge that compares the program's outputs against them.

It imports neither JAX nor ``fxtpu`` nor anything of ``fxtpu_torch``, and
takes nothing the program made: it works the window, the DC means, the
carried history and the calibration out again from the samples the
harness made.  Each function also runs as the control, with every
operation rounded to bfloat16 (``rnd=bf16``)."""
