"""MLA's absorbed attention over the paged latent pool on the card
(``repro_torch.kernels.ops.mla_latent_attend``, ``csrc/mla_latent_attend.cu``)
against its plain version (``ops.mla_latent_attend_ref``, run on the same
card with float32 products in float32).

Cases, at DeepSeek-V2-Lite's widths (latent 512, rope 64, 16 heads, pages
of 16): the doc cell's decode, 32 slots over 5120 positions at mixed
positions up to 5119 (page boundaries, retired slots on page 0, slots
sharing their first pages); its chunk, 256 rows over 4608 positions at
start 0 and at start 4096; and at MiniCPM3-4B's (latent 256, rope 32, 40
heads): 8 slots over 2048 positions, and a 64-row chunk at start 1000;
and at other page sizes (any multiple of 8 is taken: pages are read in
boxes of gcd(page, 32) rows): DeepSeek-V2-Lite's decode on pages of 64
and its chunk at start 4096 on pages of 8, MiniCPM3's decode on pages of
24. The queries come with the row strides the engine's product gives them.

Tolerance: |o - o_plain| / |o_plain| <= 1e-4 (Frobenius norms). Both
sides round p to bf16 after the division; where the two float32 scores
(summed in other orders, ~1e-6 apart) straddle a bf16 rounding boundary
of p, an element of p moves one bf16 ulp (2^-8 of it). Such flips are
sparse: on an H100 the cases below read 8e-7 - 7.2e-5 (the most in a
chunk at start 0, whose first rows see a few keys with large weights).
The same plain version with the query rounded to TF32 (TF32 scores, a
precision below the configuration's) reads 3.0e-4 - 8.3e-4, and with it
rounded to bf16 8.8e-4 - 2.3e-3: each case checks that both lie above
twice the tolerance. 1e-4 sits between the largest sound reading and
half the smallest TF32 one, 1.4x and 1.5x from each. Also: one launch a
call, and runs bit-identical.

The tests skip without a card; run them on one with ``PYTHONPATH=src python
-m pytest -m cuda --noconftest tests/test_torch_mla_latent_attend.py``
(this file imports no JAX)."""
import pytest
import torch

from repro_torch.kernels import ops

TOL = 1e-4
# name -> (latent, rope, heads, page size, slots (decode) or 1 (chunk),
# rows a group (1 or the chunk), positions the plain version reads, the
# chunk's start)
CASES = {
    "dsv2_decode": (512, 64, 16, 16, 32, 1, 5120, None),
    "dsv2_chunk_0": (512, 64, 16, 16, 1, 256, 4608, 0),
    "dsv2_chunk_4096": (512, 64, 16, 16, 1, 256, 4608, 4096),
    "minicpm3_decode": (256, 32, 40, 16, 8, 1, 2048, None),
    "minicpm3_chunk": (256, 32, 40, 16, 1, 64, 2048, 1000),
    "dsv2_decode_page64": (512, 64, 16, 64, 32, 1, 5120, None),
    "dsv2_chunk_4096_page8": (512, 64, 16, 8, 1, 256, 4608, 4096),
    "minicpm3_decode_page24": (256, 32, 40, 24, 8, 1, 2048, None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(name, dev):
    """The inputs of one case: queries laid out as the engine's einsum
    leaves them (heads outermost), a pool of bf16 noise, page tables and
    positions."""
    R, DR, H, ps, G, S, T, start = CASES[name]
    g = torch.Generator(device=dev).manual_seed(list(CASES).index(name))
    n_logical = -(-T // ps)
    N = G * S
    q_lat = (torch.randn((H, N, R), generator=g, device=dev) * 0.2
             ).transpose(0, 1)
    q_rope = torch.randn((N, H, DR), generator=g, device=dev) * 0.9
    pages = G * n_logical + 2
    c = torch.randn((pages, ps, R), generator=g, device=dev).bfloat16()
    kr = torch.randn((pages, ps, DR), generator=g, device=dev).bfloat16()
    table = 1 + torch.randperm(pages - 2, generator=g, device=dev)[
        :G * n_logical].reshape(G, n_logical).int()
    if start is None:
        last = torch.randint(0, T, (G,), generator=g, device=dev).int()
        fixed = [T - 1, ps - 1, ps, 2 * ps - 1, 0, T // 2]
        last[:len(fixed)] = torch.tensor(fixed, device=dev)
        if G > 8:
            table[6:8] = 0                      # retired slots: page 0
            table[8, :4] = table[9, :4]         # shared prefix pages
    else:
        last = start + torch.arange(S, device=dev, dtype=torch.int32)
    scale = 0.1147
    return dict(q_lat=q_lat, q_rope=q_rope, c=c, kr=kr, page_table=table,
                last=last, scale=scale, read_len=T)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).view(x.shape)


def _rounded_query(kw, rnd):
    return {**kw, "q_lat": rnd(kw["q_lat"]), "q_rope": rnd(kw["q_rope"])}


def _gap(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name):
    kw = _case(name, cuda)
    want = ops.mla_latent_attend_ref(**kw)
    launches = ops.mla_latent_attend.launches
    got = ops.mla_latent_attend(**kw)
    again = ops.mla_latent_attend(**kw)
    torch.cuda.synchronize()
    assert ops.mla_latent_attend.launches == launches + 2
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    gap = _gap(got, want)
    peak = float((got - want).abs().max() / want.abs().max())
    assert gap <= TOL, (gap, peak)
    # the bar tells apart a query rounded to TF32 (TF32 scores) or to bf16
    for rnd in (_tf32, lambda q: q.bfloat16().float()):
        ctl = ops.mla_latent_attend_ref(**_rounded_query(kw, rnd))
        assert _gap(ctl, want) > 2 * TOL
