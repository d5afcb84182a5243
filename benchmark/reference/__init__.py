"""The plain reference that decides ``correct``: plain PyTorch in
float32 with TF32 off.  It imports nothing of the program (nor JAX, nor
the JAX package) and takes nothing the program made."""
