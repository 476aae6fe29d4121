"""Deterministic random stream compatible with the reference engine.

Copy of ``uniform_f64_stream``, ``ReferenceRng`` and the ChaCha20 code
they need from ``lightdock_tpu/utils/rng.py``.  The reference draws one uniform f64 per
glowworm per step from Rust ``rand 0.7``'s ``StdRng`` (ChaCha20) seeded by
``seed_from_u64``, which expands the u64 seed into a 32-byte key with a
PCG32 stream; ``gen::<f64>()`` converts ``next_u64`` with the 53-bit
multiply.  Vectorised NumPy computes a whole run's draws at once.
"""

from __future__ import annotations

import numpy as np

_PCG_MUL = np.uint64(6364136223846793005)
_PCG_INC = np.uint64(11634580027462260723)

_CHACHA_CONST = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def expand_seed(seed: int) -> np.ndarray:
    """Expand a u64 seed into 8 little-endian u32 key words (PCG32 fill)."""
    state = np.uint64(seed)
    words = np.empty(8, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(8):
            state = state * _PCG_MUL + _PCG_INC
            xorshifted = np.uint32(((state >> np.uint64(18)) ^ state) >> np.uint64(27))
            rot = np.uint32(state >> np.uint64(59))
            words[i] = np.uint32(
                (int(xorshifted) >> int(rot) | int(xorshifted) << ((32 - int(rot)) & 31))
                & 0xFFFFFFFF
            )
    return words


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(state: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 7)


def chacha20_keystream_words(key_words: np.ndarray, n_words: int) -> np.ndarray:
    """First ``n_words`` little-endian u32 words of the ChaCha20 keystream
    (64-bit block counter from 0, 64-bit nonce 0: the rand_chacha layout),
    all blocks in one vectorised pass."""
    n_blocks = (n_words + 15) // 16
    counters = np.arange(n_blocks, dtype=np.uint64)
    state = np.empty((16, n_blocks), dtype=np.uint32)
    state[0:4] = _CHACHA_CONST[:, None]
    state[4:12] = key_words[:, None]
    state[12] = counters.astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[14] = 0
    state[15] = 0

    working = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):  # 20 rounds = 10 double rounds
            _quarter(working, 0, 4, 8, 12)
            _quarter(working, 1, 5, 9, 13)
            _quarter(working, 2, 6, 10, 14)
            _quarter(working, 3, 7, 11, 15)
            _quarter(working, 0, 5, 10, 15)
            _quarter(working, 1, 6, 11, 12)
            _quarter(working, 2, 7, 8, 13)
            _quarter(working, 3, 4, 9, 14)
        working += state
    # words of block b are working[:, b]; stream order is block-major.
    return working.T.reshape(-1)[:n_words]


class ReferenceRng:
    """Sequential access to the rand-0.7-compatible uniform f64 stream
    (the draws of ``uniform_f64_stream``, handed out in order; the setup's
    pose sampler, ``setup_sim.sample_glowworms``, draws from it)."""

    _CHUNK = 4096  # doubles generated per refill

    def __init__(self, seed: int):
        self.key = expand_seed(seed)
        self._drawn = 0          # doubles handed out so far
        self._buf = np.empty(0, dtype=np.float64)
        self._buf_start = 0      # stream index of _buf[0]

    def gen(self, n: int = 1) -> np.ndarray:
        """Draw the next ``n`` uniform f64 values in [0, 1)."""
        end = self._drawn + n
        if end > self._buf_start + len(self._buf):
            total = max(end, self._drawn + self._CHUNK)
            words = chacha20_keystream_words(self.key, 2 * total)
            lo = words[0::2].astype(np.uint64)
            hi = words[1::2].astype(np.uint64)
            u64 = lo | (hi << np.uint64(32))
            self._buf = (u64 >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
            self._buf_start = 0
        off = self._drawn - self._buf_start
        out = self._buf[off:off + n].copy()
        self._drawn = end
        return out


def uniform_f64_stream(seed: int, n: int) -> np.ndarray:
    """The first ``n`` uniform f64 draws for ``seed`` as one array."""
    words = chacha20_keystream_words(expand_seed(seed), 2 * n)
    lo = words[0::2].astype(np.uint64)
    hi = words[1::2].astype(np.uint64)
    u64 = lo | (hi << np.uint64(32))
    return (u64 >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
