"""Generation: prior sampling and free-running (autoregressive) decoding.

Port of ``molvax/latent/sample.py:36-208,246-361``. ``generate``
routes as the reference does: 'repeat_z' decoders decode in one
non-autoregressive pass (``nn.decoder.decode``). With
``cfg.use_pallas_generation`` on, a teacher-forced decoder, bf16 matmuls,
``constrained=False`` and tensors on CUDA, the whole decode is one launch of
the hand-written generation kernel (``kernels/generate.py``) and no logits
are materialized. Otherwise the fp32 scan runs as a loop over T of
``nn.decoder.decoder_stepper``'s steps: on the CPU ``decoder_step`` in plain
torch ops; on a card the hand-written step kernels of ``kernels.generate.FusedStep``
(``csrc/decode_step.cu``: the packed weights and z's half of layer 0's
gates once a decode, then one fused GRU-cell launch a layer and one head
launch a step, in fp32 with 3xTF32 products), which beam search runs too.

``constrained=True`` threads the valence automaton (``latent/constrain.py``)
through the decode, as the reference does: the GRU step stays the fp32
scan, and each step's scores (the logits, or logits / temperature + Gumbel
noise) go through one ``kernels.automaton.auto_step`` with n=1, which masks
the illegal tokens, picks the first maximum and advances the automaton: the
hand-written kernel on CUDA, its plain version on the CPU. A 'repeat_z'
decoder takes one ``auto_step`` with n=T over its precomputed scores. The
generation kernel is never taken when ``constrained=True``. A sampled decode
of either makes the Gumbel noise of all T steps once, before its steps: one
(T, B, C) table (``kernels.generate.gumbel_table``: one launch of
``csrc/noise.cu`` on a card, its plain version on the CPU), bit for bit the
per-step ``gumbel_noise``; step t reads ``table[t]``.

Host-side draws (z from the prior, the reparameterization noise, the
sampling seed) come from a ``torch.Generator``; its stream differs from
``jax.random``'s, so tests hand both packages the same numpy inputs.

``mesh=`` on ``sample_prior`` and ``sample_aggregate`` decodes data-parallel
(``parallel.map_rows``): every rank draws the global z and the noise seed
from a generator in the same state, decodes its rows of z with the noise
of their global rows (``row_base``), and every rank gets all the strings,
those of the 1-rank call.

On a card the scan route's T steps become one CUDA Graph (``CapturedDecode``)
once a key (``_decode_key``: the shape, the mode, the charset, the matmul
settings, the weights' addresses, the automaton's step function, the device)
comes back: a key's first two calls run them op by op, as the CPU does
(``_scan``), its third captures them, and every later call replays the
graph. A replay draws the noise of the request's seed from a device tensor,
so it decodes what the op-by-op loop decodes, bit for bit. A key called once
or twice thus pays no capture (``evaluate()`` decodes each of its keys at
most twice, on a new copy of the model where it reads EMA weights), and a
key that keeps coming back pays one, at its third call.
``graph_captures`` and ``graph_replays`` count the graphs made and the
decodes that replayed a graph an earlier call made. A model's decodes on a
card share their graphs' static buffers, so they must not run from several
threads at once.

A grammar config (``ModelConfig.alphabet``, the Grammar VAE) takes one
route for ``generate``, ``sample_prior``, ``sample_aggregate`` and
``reconstruct`` (greedy: the masked argmax): the 'repeat_z' decoder's one
pass of logits through the stack kernels (``decode``, in blocks of
``GRAMMAR_DECODE_ROWS`` rows), then one launch of the pushdown walk
(``kernels.grammar_walk.walk``: the noise, the grammar's mask, the first
maximum, the stack, the rule and terminal codes; its plain version on the
CPU), one copy to the host and a table lookup to strings
(``Grammar.strings``). Its codes are rule codes. ``constrained=True`` and
beam search raise ``ValueError`` there: the valence automaton works on
characters, the walk's mask is the grammar's own.

Under a running profiler a request is marked in spans (``utils.span``):
``sample.draw_z``, ``sample.decode`` (and on the scan route ``sample.capture``
and ``sample.replay`` on a card; where the steps run op by op and inside a
capture, ``sample.noise`` once a sampled decode, around its noise table,
then ``sample.step`` a step, holding ``sample.select`` (``auto_step``,
or the CPU's first maximum; on a card with no automaton the head kernel
selects); on the
grammar route ``sample.select`` holding ``sample.walk``), then
``sample.to_host``, where the host waits for the card, and ``sample.strings``.
"""

from __future__ import annotations

import collections
import weakref
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.alphabet import DEFAULT_CHARSET, Charset, Grammar, alphabet_of, strings
from ..kernels import automaton as kauto
from ..kernels import generate as kgen
from ..kernels import grammar_walk as kwalk
from ..nn.decoder import decode, decoder_stepper, latent_embed
from ..nn.vae import reparameterize
from ..parallel import map_rows
from ..utils import capture_graph, matmul_dtype, span
from .constrain import build_tables
from .embed import encode_codes_chunked, posterior_of


# scan-route decodes on a card (``CapturedDecode``): graphs captured, and
# decodes that replayed a graph captured by an earlier call
graph_captures = 0
graph_replays = 0

# a key's call that captures its graph: the calls before it run op by op
_CAPTURE_AT_CALL = 3
# keys a model keeps, counted or captured; the least recently used goes
# first. A full evaluate() (beam, the temperature sweep, optimization with
# and without the automaton) of a strict-fp32 model decodes 10 keys on the
# scan route in 13 calls (tests/test_torch_decode_graph.py counts them), so
# a repeated report finds all of its keys again.
_KEYS_PER_MODEL = 10
_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

# rows of z a grammar decode sends through the stack kernels at once: the
# forward stores its residuals (~6 MB a row at gvae_zinc's widths), and the
# recurrence's plan takes 1,024 rows a launch at H=501, so blocks of 2,048
# rows bound the memory without adding recurrence launches
GRAMMAR_DECODE_ROWS = 2048


def _default_generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _draw_seed(generator: torch.Generator) -> int:
    """A 32-bit seed for the decode's sampling noise, drawn from ``generator``."""
    return int(torch.randint(0, 1 << 32, (), generator=generator, device=generator.device))


def generate(
    model,
    cfg,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    greedy: bool = True,
    temperature: float = 1.0,
    constrained: bool = False,
    charset: Charset = DEFAULT_CHARSET,
    row_base: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """z (B, latent) -> (codes (B, T) int32, logits (B, T, C) or None).

    On the kernel route the logits are never materialized and the second
    value is None; callers that need logits must take the scan route
    (``dataclasses.replace(cfg, use_pallas_generation=False)``). Sampling
    (``greedy=False``) draws Gumbel-max noise keyed by a seed drawn from
    ``generator``, identical on both routes (``kernels.generate.noise_bits``).
    ``constrained=True`` masks every step through the valence automaton
    (module docstring) and always returns the logits. ``row_base``: the
    global index of z's first row, which keys its sampling noise (a
    data-parallel rank's share of a global batch)."""
    if isinstance(alphabet := alphabet_of(cfg, charset), Grammar):
        with span("sample.decode"):
            out, logits = _grammar_generate(model, cfg, alphabet, z, generator, greedy, temperature, constrained,
                                            row_base)
        return out[:, : cfg.max_len].to(torch.int32), logits
    if alphabet.size != cfg.charset_size:
        raise ValueError(f"charset size {alphabet.size} {'<' if alphabet.size < cfg.charset_size else '>'} model "
                         f"charset_size {cfg.charset_size}: pass the charset the model was trained on")
    with span("sample.decode"):
        return _generate(model, cfg, z, generator, greedy, temperature, constrained, alphabet, row_base)


def _grammar_generate(model, cfg, grammar: Grammar, z: torch.Tensor, generator, greedy: bool, temperature: float,
                      constrained: bool, row_base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A grammar config's decode in ``grammar``: (the walk's (B, 3T) uint8
    rule and terminal codes, the logits (B, T, R))."""
    if constrained:
        raise ValueError(f"constrained=True: the valence automaton works on characters, and a {grammar.name} "
                         "config decodes under its grammar's own mask (the pushdown walk)")
    generator = generator if generator is not None else _default_generator()
    seed = _draw_seed(generator)
    with torch.no_grad():
        logits = torch.empty(z.shape[0], cfg.max_len, cfg.charset_size, device=z.device)
        for i in range(0, z.shape[0], GRAMMAR_DECODE_ROWS):
            logits[i:i + GRAMMAR_DECODE_ROWS] = decode(model, cfg, z[i:i + GRAMMAR_DECODE_ROWS])
        with span("sample.select"), span("sample.walk"):
            return kwalk.walk(logits, grammar, seed, greedy, temperature, row_base), logits


def _generate(model, cfg, z: torch.Tensor, generator: Optional[torch.Generator], greedy: bool, temperature: float,
              constrained: bool, charset: Charset, row_base: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``generate``'s decode, after its checks."""
    generator = generator if generator is not None else _default_generator()
    seed = _draw_seed(generator)
    T = cfg.max_len
    with torch.no_grad():
        if cfg.decoder_conditioning == "repeat_z":
            # one non-autoregressive pass: the decoder never sees its outputs
            logits = decode(model, cfg, z)
            scores = logits
            if not greedy:
                with span("sample.noise"):
                    table = kgen.gumbel_table(seed, T, z.shape[0], cfg.charset_size, z.device, row_base)
                scores = logits / temperature + table.transpose(0, 1)
            with span("sample.select"):
                if constrained:
                    # non-autoregressive logits, sequential constrained selection
                    itab, state = _automaton(charset, z.shape[0], T, z.device)
                    return kauto.auto_step(itab, state, scores.float().contiguous(), T - 1), logits
                return torch.argmax(scores, dim=-1).to(torch.int32), logits

        if cfg.use_pallas_generation and not constrained and kgen.generation_kernel_supported(cfg, z.device):
            codes = kgen.fused_generate(model, cfg, latent_embed(model, cfg, z), seed, greedy=greedy,
                                        temperature=temperature, row_base=row_base)
            return codes, None
        return _scan_route(model, cfg, z, seed, greedy, temperature, constrained, charset, row_base)


def _automaton(charset: Charset, B: int, T: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valence automaton's packed tables and the packed initial state of
    B rows (``kernels.automaton``), on ``device``."""
    return kauto.pack_tables(build_tables(charset)).to(device), kauto.new_state(B, T, device)


def _scan(model, cfg, z: torch.Tensor, seed: Union[int, torch.Tensor], temperature: Optional[float],
          itab: Optional[torch.Tensor], state: Optional[torch.Tensor], row_base: int, codes: torch.Tensor,
          logits: torch.Tensor, steps: Optional[int] = None) -> None:
    """The scan route's decode over its buffers: z's embedding, then the
    first ``steps`` (all T by default) steps of the fp32 GRU, the head, the
    scores and the selection, into codes[:, t] (B, T) int32 and logits[:, t]
    (B, T, C). The scores are the logits (``temperature`` None, greedy), or
    logits / temperature + the step's slice of the noise table, made once
    before the steps (``kernels.generate.gumbel_table``, the noise of the
    global rows from ``row_base``). With ``itab`` each step goes through one
    ``auto_step``, which advances the packed automaton ``state`` in place.
    The step is ``nn.decoder.decoder_stepper``'s, picked by device once:
    on a card the hand-written step kernels (``kernels.generate.FusedStep``:
    its packing and z's gates, then per step its L cell launches and its
    head, which writes logits[:, t] and either the scores for ``auto_step``
    or, with no automaton, the first maximum into codes[:, t]), on the CPU
    ``decoder_step``. Step t + 1 reads the code of step t where it lies
    (``auto_step``'s outputs gathered into codes once, after the steps); the
    hidden states alternate between two buffers. ``seed`` is a Python int
    or a 0-d int64 tensor on z's device (``kernels.generate.seed_word``):
    the same noise. ``_eager_scan`` runs it op by op; ``CapturedDecode``
    captures it."""
    B, T, C = z.shape[0], cfg.max_len, cfg.charset_size
    n = T if steps is None else steps
    z_emb = latent_embed(model, cfg, z)
    table = None
    if temperature is not None:
        with span("sample.noise"):
            table = kgen.gumbel_table(seed, n, B, C, z.device, row_base)
    stepper = decoder_stepper(model, cfg, z_emb)
    hbuf = stepper.state(2)
    scores = None if itab is None else torch.empty(B, C, device=z.device)
    picked, prev = [], None
    for t in range(n):
        with span("sample.step"):
            stepper.step(hbuf[t % 2], hbuf[(t + 1) % 2], prev, logits[:, t], scores,
                         None if table is None else table[t], 1.0 if temperature is None else temperature,
                         None if itab is not None else codes[:, t])
            if itab is None:
                prev = codes[:, t]
            else:
                with span("sample.select"):
                    picked.append(kauto.auto_step(itab, state, scores, T - 1 - t))
                prev = picked[-1][:, 0]
    if picked:
        codes[:, :n] = torch.cat(picked, dim=1)


def _eager_scan(model, cfg, z: torch.Tensor, seed: Union[int, torch.Tensor], greedy: bool, temperature: float,
                constrained: bool, charset: Charset, row_base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan route's decode op by op, on fresh buffers: the CPU's route
    and a key's first call on a card, and what a replay must equal.
    (codes, logits)."""
    B, T, C = z.shape[0], cfg.max_len, cfg.charset_size
    itab, state = _automaton(charset, B, T, z.device) if constrained else (None, None)
    codes = torch.empty(B, T, dtype=torch.int32, device=z.device)
    logits = torch.empty(B, T, C, device=z.device)
    _scan(model, cfg, z, seed, None if greedy else temperature, itab, state, row_base, codes, logits)
    return codes, logits


def _decode_key(model, cfg, z: torch.Tensor, greedy: bool, temperature: float, constrained: bool,
                charset: Charset, row_base: int) -> tuple:
    """What a captured decode bakes in: z's shape and type, T and C, the
    mode (``greedy``, ``temperature``, ``constrained``, ``row_base``), the
    charset, the matmul type and torch's fp32 matmul settings (they pick
    the cuBLAS kernels), the address, shape and type of every parameter
    (the graph reads the decoder's weights where they lie, so in-place
    updates need no new capture; a moved weight does), the automaton's step
    function (the kernel's wrapper or its plain version) and the device."""
    weights = tuple((p.data_ptr(), tuple(p.shape), p.dtype) for p in model.parameters())
    return (tuple(z.shape), z.dtype, cfg.max_len, cfg.charset_size, greedy, temperature, constrained, row_base,
            charset.chars, matmul_dtype(cfg, z.device), torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32, weights, kauto.auto_step, z.device)


class CapturedDecode:
    """The scan route's T steps of one key (``_decode_key``) captured in one
    CUDA Graph, replayed per request.

    The graph reads a static z, a 0-d int64 noise seed, the automaton's
    tables (packed once here) and the model's weights in place, resets the
    automaton state from a kept initial state, and writes static codes and
    logits; everything it makes between them lives in its private memory
    pool, which its steps share. It writes none of the model's tensors.
    Before capture the first step runs for real on the capturing stream
    (``utils.capture_graph``), and counts its one ``auto_step`` launch,
    sampled its one noise table's (``kernels.generate.gumbel_table``, of
    one step), and its step kernels' (``kernels.generate.decode_step_launches``:
    2 + L + 1); the capture records T ``auto_step`` launches, one table's at
    the graph's head and 2 + T (L + 1) step launches, which do not run, and
    each replay counts them (T, or 0 under the plain automaton; 1 table
    sampled, 0 greedy)."""

    def __init__(self, model, cfg, z: torch.Tensor, greedy: bool, temperature: float, constrained: bool,
                 charset: Charset, row_base: int):
        dev = z.device
        B, T, C = z.shape[0], cfg.max_len, cfg.charset_size
        self.z = z.clone()
        self.seed = torch.zeros((), dtype=torch.int64, device=dev)
        self.itab = self.state0 = self.state = None
        if constrained:
            self.itab, self.state0 = _automaton(charset, B, T, dev)
            self.state = self.state0.clone()
        self.codes = torch.empty(B, T, dtype=torch.int32, device=dev)
        self.logits = torch.empty(B, T, C, device=dev)

        def run(steps: Optional[int] = None) -> None:
            if self.state is not None:
                self.state.copy_(self.state0)
            _scan(model, cfg, self.z, self.seed, None if greedy else temperature, self.itab, self.state, row_base,
                  self.codes, self.logits, steps)

        def body() -> Tuple[int, int, int]:
            before = kauto.step_launches, kgen.noise_table_launches, kgen.decode_step_launches
            run()
            recorded = (kauto.step_launches - before[0], kgen.noise_table_launches - before[1],
                        kgen.decode_step_launches - before[2])
            kauto.step_launches, kgen.noise_table_launches, kgen.decode_step_launches = before
            return recorded

        self.graph, self.launches, _ = capture_graph(dev, lambda: run(1), body)

    def replay(self, z: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One request: z into the static z, the seed into the seed tensor,
        one replay; (codes, logits) are copies, since the next replay
        rewrites the graph's own."""
        with span("sample.replay"):
            self.z.copy_(z)
            self.seed.fill_(seed)
            self.graph.replay()
        kauto.step_launches += self.launches[0]
        kgen.noise_table_launches += self.launches[1]
        kgen.decode_step_launches += self.launches[2]
        return self.codes.clone(), self.logits.clone()


def _entry(model, key: tuple, make):
    """The model's entry of ``key`` and whether ``make()`` made it now:
    (None, False) for the key's calls before its ``_CAPTURE_AT_CALL``-th,
    which the caller runs op by op; at that call (``make()``, True); later
    (that entry, False). A model keeps ``_KEYS_PER_MODEL`` keys, the least
    recently used dropped first; its entries go with it."""
    entries = _graphs.setdefault(model, collections.OrderedDict())
    entry = entries.pop(key, 0)  # the calls so far, or the key's graph
    made = isinstance(entry, int) and entry + 1 >= _CAPTURE_AT_CALL
    if made:
        entry = make()
    entries[key] = entry + 1 if isinstance(entry, int) else entry
    while len(entries) > _KEYS_PER_MODEL:
        entries.popitem(last=False)
    return (None if isinstance(entry, int) else entry), made


def _scan_route(model, cfg, z: torch.Tensor, seed: int, greedy: bool, temperature: float, constrained: bool,
                charset: Charset, row_base: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan route: op by op on the CPU and at a key's first calls on a
    card (``_entry``); the key's graph, once captured, replayed."""
    global graph_captures, graph_replays

    if z.device.type != "cuda":
        return _eager_scan(model, cfg, z, seed, greedy, temperature, constrained, charset, row_base)

    def capture() -> CapturedDecode:
        with span("sample.capture"):
            return CapturedDecode(model, cfg, z, greedy, temperature, constrained, charset, row_base)

    entry, made = _entry(model, _decode_key(model, cfg, z, greedy, temperature, constrained, charset, row_base),
                         capture)
    if entry is None:
        return _eager_scan(model, cfg, z, seed, greedy, temperature, constrained, charset, row_base)
    if made:
        graph_captures += 1
    else:
        graph_replays += 1
    return entry.replay(z, seed)


def sample_prior(
    model,
    cfg,
    n: int,
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    greedy: bool = True,
    temperature: float = 1.0,
    scale: float = 1.0,
    constrained: bool = False,
    mesh=None,
    with_codes: bool = False,
):
    """Decode n latents from the prior z ~ N(0, scale^2 I) to SMILES strings.
    z is drawn from ``generator`` on its device, then moved to the model's.
    ``mesh`` decodes data-parallel over its 'data' axis (n must divide by
    it; every rank passes a generator in the same state): the strings of
    the 1-rank call, on every rank. ``with_codes``: (strings, the decode's
    codes (n, T) on the host: rule codes on a grammar config)."""
    generator = generator if generator is not None else _default_generator()
    with span("sample.draw_z"):
        z = scale * torch.randn(n, cfg.latent_dim, generator=generator, device=generator.device)
    return _decode_over(model, cfg, z, generator, greedy, temperature, constrained, charset, mesh, with_codes)


def _decode_over(model, cfg, z: torch.Tensor, generator, greedy: bool, temperature: float, constrained: bool,
                 charset: Charset, mesh, with_codes: bool = False):
    """``generate`` of z's rows on the model's device, data-parallel over
    ``mesh`` where one is given (the reference's divisibility check), as
    strings; with ``with_codes`` (strings, the codes (B, T) on the host,
    from the same copy)."""
    if mesh is not None and mesh.collective and z.shape[0] % mesh.data:
        raise ValueError(f"batch {z.shape[0]} not divisible by mesh data axis {mesh.data}")
    walk = isinstance(alphabet := alphabet_of(cfg, charset), Grammar)

    def decode_rows(part: torch.Tensor, row_base: int) -> torch.Tensor:
        part = part.to(model.device)
        if not walk:
            return generate(model, cfg, part, generator, greedy=greedy, temperature=temperature,
                            constrained=constrained, charset=charset, row_base=row_base)[0]
        with span("sample.decode"):
            return _grammar_generate(model, cfg, alphabet, part, generator, greedy, temperature, constrained,
                                     row_base)[0]

    out = map_rows(mesh, z, decode_rows)
    with span("sample.to_host"):  # the host waits here for the decode on the card
        out = out.cpu()
    with span("sample.strings"):  # the walk's terminal codes follow its T rule codes: one table lookup
        smiles = alphabet.strings(out[:, cfg.max_len:].numpy()) if walk else strings(out, charset=alphabet)
    return (smiles, out[:, : cfg.max_len]) if with_codes else smiles


def fit_aggregate_posterior(
    model, cfg, codes, batch: int = 512, max_n: int = 20_000
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N(mean, cov) fitted to the model's aggregate posterior over the
    first ``max_n`` rows of ``codes``: mean and covariance of the encoded
    mu's, plus the mean encoder noise the decoder was trained to absorb
    (cov += eps_scale^2 * E[sigma^2], diagonal), in float64 on the host.
    A trained posterior rarely matches the prior N(0, I) (in the small-eps
    lineage the means spread far past the prior's shell), so samples from
    this fit land on the data manifold where prior samples may not.

    Returns (mean (L,), chol (L, L)), fp32 on the model's device: pass
    them to ``sample_aggregate``."""
    n = min(codes.shape[0], max_n)
    mu_all, logvar_all = encode_codes_chunked(model, cfg, np.asarray(codes)[:n], batch=batch)
    mu_all = mu_all.astype(np.float64)
    var_mean = np.exp(logvar_all.astype(np.float64)).mean(axis=0)
    mean = mu_all.mean(axis=0)
    cov = np.cov(mu_all.T) + np.diag(cfg.eps_scale**2 * var_mean)
    # jitter keeps the factorization stable when some dims are collapsed
    chol = np.linalg.cholesky(cov + 1e-6 * np.eye(cov.shape[0]))
    to = dict(dtype=torch.float32, device=model.device)
    return torch.as_tensor(mean, **to), torch.as_tensor(chol, **to)


def sample_aggregate(
    model,
    cfg,
    n: int,
    generator: Optional[torch.Generator],
    mean: torch.Tensor,
    chol: torch.Tensor,
    charset: Charset = DEFAULT_CHARSET,
    greedy: bool = True,
    temperature: float = 1.0,
    constrained: bool = False,
    mesh=None,
) -> List[str]:
    """Decode n latents z = mean + chol @ eps, eps ~ N(0, I) drawn from
    ``generator`` on its device (``fit_aggregate_posterior``), to SMILES.
    ``mesh`` as ``sample_prior``'s."""
    generator = generator if generator is not None else _default_generator()
    eps = torch.randn(n, cfg.latent_dim, generator=generator, device=generator.device)
    z = mean[None, :] + eps.to(mean.device) @ chol.T
    return _decode_over(model, cfg, z, generator, greedy, temperature, constrained, charset, mesh)


def reconstruct(
    model,
    cfg,
    smiles: List[str],
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    stochastic: bool = False,
) -> List[str]:
    """encode -> (mu, or z sampled around it) -> greedy free-running decode
    -> strings."""
    generator = generator if generator is not None else _default_generator()
    mu, logvar = posterior_of(model, cfg, smiles, charset)
    z = reparameterize(mu, logvar, cfg.eps_scale, generator) if stochastic else mu
    return _decode_over(model, cfg, z, generator, True, 1.0, False, charset, None)
