"""Design probes of the hand-written kernels, on the card.

Counterparts of the reference's TPU probes under ``bench/``, each runnable
as ``python -m molvax_torch.probes.<name>`` on a CUDA card and callable from
``chip_smoke.py``:

  * ``gru_experiments``: where a GRU recurrence step's time goes (the serial
    h @ W_hh chain, the gate math, the residual stores), and a 3-layer
    forward on the stack route, on three layer launches and in one
    wavefront launch of all layers (fused3), beside the per-layer pieces
    doing fused3's work;
  * ``proto_gi_kernel``: the input GEMM inside the recurrence kernel against
    a hoisted one;
  * ``auto_loop_probe``: the automaton per step as n=1 launches and as one
    n=T launch, the per-step budget, and (``--floor``) the int32-op floor;
  * ``stack_probe`` (this port's own, run by path): the redesigned stack's
    kernels timed and a recurrence step decomposed, and the GRU kernels of
    another checkout (``--root``) for a parent-against-change comparison;
  * ``capture_probe`` (this port's own): whether each cooperative launch
    captures into a CUDA Graph and replays bit for bit, as the chunked
    trainer needs.

Each probe module has ``make_inputs`` (seeded, on the card), ``probe``
(one run of each probe kernel, which ``chip_smoke.py`` counts) and
``measure`` (the timed table). Single launches are timed with
``train.profiling.event_ms`` (CUDA events), host-composed sequences with
``train.profiling.step_timer``.
"""
