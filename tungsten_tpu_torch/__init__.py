"""tungsten_tpu_torch — the PyTorch/CUDA port of tungsten_tpu.

The JAX package `tungsten_tpu` stays the reference; this package mirrors its
layout so each module has an obvious counterpart:

- `utils/`    xxhash32 counter RNG on int64-held uint32 words, vector math.
- `ops/`      the GPIS evaluators: covariance, means, sparse-convolution
              noise (the batched per-ray evaluator and the march-step
              evaluator) and weight-space RFF realizations.
- `kernels/`  Python wrappers of the hand-written CUDA kernels, each with a
              plain PyTorch twin; `csrc/` holds the `.cu` sources.
- `models/`   transport: media, BSDFs, phase, primitives, camera and the
              wavefront path tracer.
- `scene/`    Tungsten JSON scene parsing.
- `render.py` the render entry point and CLI; `convert.py` carries a JAX
              scene across.

The device of the tensors decides the path: a CUDA tensor launches the
kernel, a CPU tensor takes the kernel's plain twin.  The package never
imports JAX.
"""

__version__ = "0.1.0"
