"""molvax_torch: the PyTorch / CUDA port of molvax, for NVIDIA Hopper.

The JAX package ``molvax`` is the reference this port is held against. This
package imports ``torch`` and numpy and never JAX, so it runs on a host that
has no JAX, and nothing of the ``molvax`` package either: it keeps its own
copies of the reference's framework-free files (``config.py``,
``data/charset.py``, ``data/smiles_check.py``), held to the originals by
the tests. Its entry points run on the card unless the caller asks for the
CPU (``device="cpu"``), as the tests do.

Ported so far: the serving path, encode -> free-running decode
(``latent.sample.generate``, ``sample_prior``, ``reconstruct``), with the
hand-written generation kernel in ``kernels/csrc/generate.cu``; and the
training step (``train.init_state``, ``make_train_step``,
``make_eval_step``: teacher-forced forward, ELBO, Adam), with hand-written
kernels for the encoder (``conv_enc.cu``), the sampler (``sampler.cu``),
the GRU stack's forward and backward (``gru_stack.cu``) and the per-layer
GRU (``gru_layer.cu``); and constrained decoding and beam search
(``latent.sample.generate(constrained=True)``, ``latent.beam``), with the
hand-written valence-automaton kernel ``automaton.cu``; and the data layer
(``data``: the corpora, the native tokenizer, property targets and the
``BatchIterator``) with the chunked trainer (``train.make_train_chunk``: K
steps as one CUDA Graph on the card); the training loop (``train.train``:
checkpoints in ``io.checkpoint``, resume, preemption, the eval cadence and
``best/``) and the latent workloads (``latent``: the corpus encode and
decode, interpolation, property optimization in z, the aggregate
posterior); evaluation (``train.evaluate``: the reference's report, key
for key, on the EMA weights) and the CLI (``python3 -m molvax_torch.cli``,
installed as ``molvax-torch``: every ``molvax`` subcommand), with the debug
guards of ``utils`` (``debug_mode``, ``assert_finite``, ``checked``); and
data parallelism (``parallel``: the reference's mesh over
``torch.distributed``, NCCL on cards and gloo on the CPU; ``mesh=`` on the
steps, the chunk, ``train``, the ``BatchIterator``, the checkpoints and the
latent workloads; every draw keyed by its global row). With it the port
does everything the JAX package does.
"""

__version__ = "0.1.0"
