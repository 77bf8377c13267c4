"""Plain PyTorch reference of what the benchmark's cells compute: the VED
pipeline (:mod:`.pipeline`) and the implicit diffusion steps
(:mod:`.solve`).  It imports nothing of the port and takes nothing the port
made: the benchmark hands it the same inputs it hands the port.
"""
