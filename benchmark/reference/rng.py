"""The GSO's random stream, written out plainly.

LightDock draws one uniform double a glowworm a step from Rust rand 0.7's
``StdRng`` (ChaCha20, 20 rounds) seeded by ``seed_from_u64``: the u64 seed
is expanded into a 32-byte key by a PCG32 stream, and ``gen::<f64>()``
takes the top 53 bits of ``next_u64``.  Every swarm of a run draws the
same stream, so step s of any swarm reads draws [s G, (s + 1) G).
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def key_words(seed: int) -> list:
    """The 8 key words that ``seed_from_u64`` makes from ``seed``."""
    state = seed & MASK64
    words = []
    for _ in range(8):
        state = (state * 6364136223846793005 + 11634580027462260723) & MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & MASK32
        rot = state >> 59
        words.append(((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32)
    return words


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def keystream(seed: int, n_words: int) -> np.ndarray:
    """The first ``n_words`` u32 words of ChaCha20 for the key of ``seed``,
    block counter from 0, nonce 0, all blocks at once."""
    n_blocks = -(-n_words // 16)
    counter = np.arange(n_blocks, dtype=np.uint64)
    init = np.zeros((16, n_blocks), dtype=np.uint32)
    init[0:4] = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                         dtype=np.uint32)[:, None]
    init[4:12] = np.array(key_words(seed), dtype=np.uint32)[:, None]
    init[12] = (counter & np.uint64(MASK32)).astype(np.uint32)
    init[13] = (counter >> np.uint64(32)).astype(np.uint32)
    x = init.copy()

    def quarter(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            quarter(0, 4, 8, 12)
            quarter(1, 5, 9, 13)
            quarter(2, 6, 10, 14)
            quarter(3, 7, 11, 15)
            quarter(0, 5, 10, 15)
            quarter(1, 6, 11, 12)
            quarter(2, 7, 8, 13)
            quarter(3, 4, 9, 14)
        x += init
    return x.T.reshape(-1)[:n_words]


def uniforms(seed: int, n: int) -> np.ndarray:
    """The first ``n`` doubles in [0, 1) of the stream of ``seed``."""
    words = keystream(seed, 2 * n).astype(np.uint64)
    u64 = words[0::2] | (words[1::2] << np.uint64(32))
    return (u64 >> np.uint64(11)).astype(np.float64) * 2.0 ** -53
