"""molvax_torch: the PyTorch / CUDA port of molvax, for NVIDIA Hopper.

The JAX package ``molvax`` is the reference this port is held against. This
package imports ``torch`` and numpy and never JAX, so it runs on a host that
has no JAX. It reads the reference's two framework-free files
(``molvax/config.py`` and ``molvax/data/charset.py``) by file path, without
importing the ``molvax`` package (see ``_shared.py``).

Ported so far: the serving path, encode -> free-running decode
(``latent.sample.generate``, ``sample_prior``, ``reconstruct``), with the
hand-written generation kernel in ``kernels/csrc/generate.cu``; and the
training step (``train.init_state``, ``make_train_step``,
``make_eval_step``: teacher-forced forward, ELBO, Adam), with hand-written
kernels for the encoder (``conv_enc.cu``), the sampler (``sampler.cu``) and
the GRU stack's forward and backward (``gru_stack.cu``).
"""

__version__ = "0.1.0"
