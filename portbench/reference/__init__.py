"""The benchmark's plain reference: Council-GAN in float32 PyTorch.

It imports nothing of the program under test and takes nothing that the
program made: the harness hands it the same weights and inputs it hands the
program, and it works out the step or the translation again.
"""
