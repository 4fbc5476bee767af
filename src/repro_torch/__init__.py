"""PyTorch/CUDA port of the TSDCFL reproduction.

A second package beside ``repro`` (the JAX reference), laid out like it:
``core`` (coding control plane, runtime, the coded train step, the
paper's ``FELTrainer``, Lyapunov scheduler), ``sim`` (co-simulated edge
cluster), ``train`` (the coded-training bridge), ``models``, ``configs``,
``optim``, ``data``, ``checkpoint``, ``launch`` (the training loop and the
serving loop) and ``kernels`` (hand-written CUDA for Hopper, each beside
its plain PyTorch version).  It imports neither ``jax`` nor ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
