"""Where the scatter event's samplers take their random numbers from.

The samplers of :mod:`grmonty_tpu_torch.ops.proba` and
:mod:`grmonty_tpu_torch.ops.scattering` draw through a draw source:

* :class:`GeneratorDraws` (what a ``torch.Generator`` passed to a sampler
  becomes): whole batches from the generator, in the order the samplers
  have always drawn them.  The CPU path draws this way.
* :class:`PhiloxDraws`: counter-based draws, Philox4x64-10 under a 128-bit
  key, each lane's numbers a function of (key, lane, sampler, round,
  block) alone.  It is the plain PyTorch version of the generator inside
  ``csrc/scatter_event.cu``, word for word: the card check runs the plain
  samplers on it and the kernel under the same key.  :func:`hot_uniforms`
  is the plain version of the hot step's own draws (``csrc/hot_step.cu``'s
  drawing instance) from the same generator.

The counter of a Philox block is the four 64-bit words (lane, sampler,
round, block); its four output words are slots 4 * block ... 4 * block + 3
of that round.  Per lane and sampler:

* ``ELECTRON`` (round r < 16, blocks 0-2): slot 0 the mixture, slots 1-6
  three Box-Muller pairs (six normals), 7 the y test, 8 ``mu``, 9 the
  Klein-Nishina test;
* ``ELECTRON_DIR`` (round 0): slot 0 the azimuth, 1-2 the random direction
  (z, phi) of the azimuthal frame;
* ``KLEIN_NISHINA`` (round r < 128): slot 0 the tentative energy, 1 the
  envelope test;
* ``THOMSON`` (round r < 16): slot 0 the cosine, 1 the test;
* ``SCATTER_DIR`` (round 0): as ``ELECTRON_DIR``, for the scattered photon;
* ``HOT`` (the round is the hot iteration's index in its block, block 0):
  slot 0 the roulette's uniform ``u_roul``, slot 1 the optical depth's
  ``u_x1`` (:func:`hot_uniforms`).

A word becomes a uniform in [0, 1) as ``torch.rand`` makes one: its top 24
bits times 2^-24 in float32, its top 53 bits times 2^-53 in float64; a
normal pair is Box-Muller on two uniforms (u1, u2): sqrt(-2 log(1 - u1))
times cos and sin of 2 pi u2.  ``numpy.random.Philox`` is the same
generator: its first four ``random_raw`` words at counter c are this
module's words at counter c + 1.

Here a 64-bit word is four 16-bit limbs in an int64 tensor, so that every
product of the 64 x 64 -> 128-bit multiplies fits int64.
"""

import math

import torch

PI = math.pi

ELECTRON, ELECTRON_DIR, KLEIN_NISHINA, THOMSON, SCATTER_DIR, HOT = range(6)

PHILOX_M = (0xD2E7470EE14C6C93, 0xCA5A826395121157)
PHILOX_W = (0x9E3779B97F4A7C15, 0xBB67AE8584CAA73B)
PHILOX_ROUNDS = 10
_MASK64 = (1 << 64) - 1
# rounds of a looping sampler computed together (the loops test for an end
# every proba._CHECK_EVERY rounds)
_ROUND_CHUNK = 4


def _limbs(v):
    """The four 16-bit limbs of a 64-bit Python int, low first."""
    return [(v >> (16 * i)) & 0xFFFF for i in range(4)]


def _mulhilo(m_limbs, x):
    """(hi, lo) 64-bit words of the 128-bit product of the constant with
    limbs ``m_limbs`` and the word ``x`` ((4, ...) limbs)."""
    m = torch.tensor(m_limbs, dtype=torch.int64, device=x.device).view(
        (1, 4) + (1,) * (x.dim() - 1))
    prod = x[:, None] * m  # (4, 4, ...): limb i of x times limb j of m, < 2^32
    cols = torch.zeros((8,) + tuple(x.shape[1:]), dtype=torch.int64, device=x.device)
    for i in range(4):
        cols[i:i + 4] += prod[i]
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for c in range(8):
        v = cols[c] + carry
        out[c] = v & 0xFFFF
        carry = v >> 16
    return out[4:], out[:4]


def philox_limbs(ctr, key):
    """Philox4x64-10 of the counters ``ctr`` (a list of four (4, ...) limb
    tensors) under ``key`` (two Python ints): the four output words as
    (4, ...) limb tensors."""
    c = list(ctr)
    k = [key[0] & _MASK64, key[1] & _MASK64]
    dev = c[0].device
    shape = (4,) + (1,) * (c[0].dim() - 1)
    for r in range(PHILOX_ROUNDS):
        if r:
            k = [(k[0] + PHILOX_W[0]) & _MASK64, (k[1] + PHILOX_W[1]) & _MASK64]
        kl = [torch.tensor(_limbs(v), dtype=torch.int64, device=dev).view(shape) for v in k]
        hi0, lo0 = _mulhilo(_limbs(PHILOX_M[0]), c[0])
        hi1, lo1 = _mulhilo(_limbs(PHILOX_M[1]), c[2])
        c = [hi1 ^ c[1] ^ kl[0], lo1, hi0 ^ c[3] ^ kl[1], lo0]
    return c


def _word_limbs(v, like):
    """A (4, ...) limb tensor of the non-negative int64 tensor (or int) ``v``
    broadcast to ``like``'s shape."""
    v = torch.as_tensor(v, dtype=torch.int64, device=like.device).expand(like.shape)
    return torch.stack([(v >> (16 * i)) & 0xFFFF for i in range(4)])


def _limbs_to_int64(limbs):
    """The int64 tensor holding the 64 bits of the words given as (4, ...)
    limbs (the top limb as a signed 16-bit number, so that nothing
    overflows)."""
    top = limbs[3] - 65536 * (limbs[3] >> 15)
    return limbs[0] + limbs[1] * 2**16 + limbs[2] * 2**32 + top * 2**48


def philox_words(ctr, key):
    """The raw words of Philox4x64-10 for an (N, 4) int64 tensor of counters
    (each holding a word's 64 bits) under ``key`` (two ints, or an int64
    tensor of two words): an (N, 4) int64 tensor of the words' bits, on
    ``ctr``'s device."""
    c = [_word_limbs(ctr[:, j], ctr[:, j]) for j in range(4)]
    return torch.stack([_limbs_to_int64(w) for w in philox_limbs(c, key_pair(key))], dim=-1)


def uniform_from_limbs(w, dtype):
    """Uniforms in [0, 1) of the words ``w`` ((4, ...) limbs): the top 24
    bits times 2^-24 in float32, the top 53 times 2^-53 in float64."""
    if dtype == torch.float32:
        top = (w[3] << 8) | (w[2] >> 8)
        return top.to(torch.float32) * 2.0 ** -24
    if dtype == torch.float64:
        top = (w[3] << 37) | (w[2] << 21) | (w[1] << 5) | (w[0] >> 11)
        return top.to(torch.float64) * 2.0 ** -53
    raise ValueError(f"no uniforms for {dtype}")


def hot_uniforms(key, step, n, dtype, device=None):
    """The hot step's two uniforms (u_roul, u_x1) of lanes 0 ... n-1 at the
    iteration ``step`` of a block under ``key`` (two ints, or an int64
    tensor of two words): slots 0 and 1 of the Philox block at the counter
    (lane, ``HOT``, step, 0), each made a uniform of ``dtype`` as
    :func:`uniform_from_limbs` makes one; (n,) tensors on ``device`` (the
    key's, or the CPU).  The plain version of the draws of the hot step's
    drawing instance."""
    if device is None:
        device = key.device if isinstance(key, torch.Tensor) else torch.device("cpu")
    lane = torch.arange(n, dtype=torch.int64, device=device)
    ctr = [_word_limbs(lane, lane), _word_limbs(HOT, lane), _word_limbs(step, lane),
           _word_limbs(0, lane)]
    w = philox_limbs(ctr, key_pair(key))
    return uniform_from_limbs(w[0], dtype), uniform_from_limbs(w[1], dtype)


def box_muller(u1, u2):
    """The normal pair of the uniforms (u1, u2)."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    t = u2 * (2.0 * PI)
    return r * torch.cos(t), r * torch.sin(t)


def key_pair(key):
    """Two Python ints from a key: an int64 tensor of two words (read to
    the host) or a pair of ints."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = key
    return int(k0) & _MASK64, int(k1) & _MASK64


class GeneratorDraws:
    """Whole batches from one ``torch.Generator``, in the samplers' order."""

    ordered_sum = False  # the chi^2 mixture's sum of squares: torch.sum
    margin = None

    def __init__(self, gen):
        self.gen = gen
        self.rounds = {}

    def _u(self, like):
        return torch.rand(like.shape, generator=self.gen, dtype=like.dtype, device=like.device)

    def electron_round(self, it, like):
        """(mixture, the six normals (6, N), y test, mu, KN test)."""
        x1 = self._u(like)
        nrm = torch.randn((6,) + tuple(like.shape), generator=self.gen, dtype=like.dtype,
                          device=like.device)
        return x1, nrm, self._u(like), self._u(like), self._u(like)

    def direction(self, sampler, like):
        """(azimuth, z, phi) of ``ELECTRON_DIR`` or ``SCATTER_DIR``."""
        return self._u(like), self._u(like), self._u(like)

    def pair_round(self, sampler, it, like):
        """The two uniforms of round ``it`` of ``KLEIN_NISHINA`` or ``THOMSON``."""
        return self._u(like), self._u(like)

    def gap(self, u, thr, live):
        """Note how close an acceptance test came (PhiloxDraws only)."""


class PhiloxDraws:
    """Counter-based draws under ``key`` (module docstring); the lane of an
    element is its index.  With ``margins``, :meth:`gap` keeps per lane the
    smallest relative distance |u - threshold| / |threshold| of any
    acceptance test it ran (``self.margin``): where a kernel that rounds
    differently may decide such a test the other way."""

    ordered_sum = True  # the sum of squares in order, as the kernel adds it

    def __init__(self, key, margins=False):
        self.key = key_pair(key)
        self.margins = margins
        self.margin = None
        self.rounds = {}
        self._chunks = {}

    def _words(self, sampler, rnd, block, like, chunk=_ROUND_CHUNK):
        """The four words of (lane, sampler, rnd, block) for every lane of
        ``like``, as (4, N) limbs each; a looping sampler's rounds are made
        ``chunk`` at a time."""
        n = like.shape[0]
        r0 = rnd - rnd % chunk
        key = (sampler, r0, block, n, str(like.device))
        if key not in self._chunks:
            lane = torch.arange(n, dtype=torch.int64, device=like.device)
            rounds = torch.arange(r0, r0 + chunk, dtype=torch.int64,
                                  device=like.device)[:, None].expand(chunk, n)
            ref = rounds
            ctr = [_word_limbs(lane, ref), _word_limbs(sampler, ref), _word_limbs(rounds, ref),
                   _word_limbs(block, ref)]
            if len(self._chunks) > 64:
                self._chunks.clear()
            self._chunks[key] = philox_limbs(ctr, self.key)
        return [w[:, rnd - r0] for w in self._chunks[key]]

    def _slots(self, sampler, rnd, like, n_blocks, chunk=_ROUND_CHUNK):
        out = []
        for b in range(n_blocks):
            out += [uniform_from_limbs(w, like.dtype)
                    for w in self._words(sampler, rnd, b, like, chunk)]
        return out

    def electron_round(self, it, like):
        s = self._slots(ELECTRON, it, like, 3)
        nrm = []
        for a in (1, 3, 5):
            nrm += box_muller(s[a], s[a + 1])
        return s[0], torch.stack(nrm), s[7], s[8], s[9]

    def direction(self, sampler, like):
        s = self._slots(sampler, 0, like, 1, chunk=1)
        return s[0], s[1], s[2]

    def pair_round(self, sampler, it, like):
        s = self._slots(sampler, it, like, 1)
        return s[0], s[1]

    def gap(self, u, thr, live):
        if not self.margins:
            return
        rel = torch.abs(u - thr) / torch.clamp(torch.abs(thr), min=torch.finfo(u.dtype).tiny)
        # a NaN threshold decides alike on both sides (the test is false)
        rel = torch.where(live, torch.nan_to_num(rel.to(torch.float64), nan=math.inf), math.inf)
        self.margin = rel if self.margin is None else torch.minimum(self.margin, rel)


def as_draws(src):
    """The draw source of ``src``: a ``torch.Generator`` becomes
    :class:`GeneratorDraws`; a draw source is returned as it is."""
    return GeneratorDraws(src) if isinstance(src, torch.Generator) else src
