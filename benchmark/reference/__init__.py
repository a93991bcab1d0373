"""The benchmark's plain reference: a straightforward float64 implementation
of what the program computes, and the comparison that decides `correct`.

It imports torch and numpy only: nothing of the program, nothing of JAX.
It takes nothing the program derived (no tree, lists, expansions or
permutations): it reads the program's outputs only to judge them.

  * :mod:`.coulomb`: the softened Coulomb sum over all sources plus the
    harmonic trap, on chosen targets, in 3 or 2 dimensions, in float64
    (the reference) or in bfloat16 (the control), and the leapfrog step's
    drift and kicks;
  * :mod:`.snapshot`: the reference's snapshot byte format, parsed;
  * :mod:`.compare`: the readings compared against each cell's limits.
"""
