"""Plain reference of hybrid search, in float32 with TF32 off.

Written from the layer equations and the scoring rules alone, in plain
``torch``: it imports neither JAX nor anything of the program, and takes
only the inputs perfbench made (text, word ids, weights, corpus arrays).
``precision="fp8"`` runs the same arithmetic with every matrix product's
operands rounded to float8 e4m3 (per-tensor scale): the control, one
precision below the configuration's bfloat16.
"""
