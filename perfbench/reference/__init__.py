"""The benchmark's plain reference of one frame, in PyTorch and NumPy.

It imports nothing of the measured program and takes nothing the program
made: it reads the scene's npz and the net's ``.gnet`` itself, works out
the tree's device form again (child pointers and rows, no jump table, no
skip distances), draws its own PCG32 stream and runs both estimators, the
joint upsample, an f32 GuidanceNet and the guided filter.  ``low=True``
computes the colour arithmetic in bfloat16 and the net's products from
float8 (e4m3) inputs: the control that the comparison must fail.
"""
