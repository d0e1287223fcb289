"""The port's wire codec against the JAX package's: the same bytes.

Every data-plane message in every draft-q mode encodes to the JAX codec's
bytes, and each side decodes the other's frames; a Hypothesis property
covers the strategies of tests/test_transport.py, empty token vectors
included. An int8 packet with no tokens has no scale: the JAX encoder fails
with a ValueError there and the port raises CodecError, also a ValueError.
The control plane's frames are held in tests/test_torch_worker.py.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.transport import codec as jcodec
from repro_torch.transport import codec

TOKS = np.asarray([5, 0, 127, 3, -1, 151935], np.int32)
Q = np.random.default_rng(0).uniform(0.0, 1.0, size=TOKS.size).astype(np.float32)


def _messages(mod):
    """One of each data-plane message of ``mod``, drafts in every q mode."""
    out = [
        mod.Hello(device_id=7, prompt=TOKS),
        mod.Hello(device_id=0, prompt=TOKS[:0]),
        mod.Admit(device_id=7, ok=True, slot=3),
        mod.Admit(device_id=2**32 - 1, ok=False),
        mod.Verdict(device_id=1, seq=42, n_accepted=2, tokens=TOKS[:3], next_prev=-1,
                    accept_rate=0.4, queue_depth=70000, queue_s=0.0125, verify_s=3.5e-3),
        mod.Verdict(device_id=1, seq=43, n_accepted=0, tokens=TOKS[:1], next_prev=9),
        mod.Fallback(device_id=3, seq=9, tokens=TOKS[:4]),
        mod.FallbackAck(device_id=3, seq=9, next_prev=-7),
        mod.Close(device_id=11),
    ]
    for qmode in mod.QMODES:
        q = None if qmode == "none" else Q
        out.append(mod.DraftPacket(device_id=1, seq=2**32 - 1, tokens=TOKS, draft_q=q,
                                   qmode=qmode))
    return out


def _same(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("i", range(len(_messages(codec))))
def test_frames_are_the_jax_codecs_bytes(i):
    """Each data-plane message (drafts in each q mode) encodes to the JAX
    codec's bytes, and each side decodes the other's frame to the same
    message."""
    mine, theirs = _messages(codec)[i], _messages(jcodec)[i]
    frame = codec.encode_frame(mine)
    assert frame == jcodec.encode_frame(theirs)
    got_here, used = codec.decode_frame(frame)
    got_there, used_there = jcodec.decode_frame(frame)
    assert used == used_there == len(frame)
    _same(got_here, got_there)


def test_q_payloads_shrink_and_decode_alike():
    """f16 and int8 payloads are smaller than f32 and decode to the JAX
    codec's f32 values bit for bit."""
    sizes = {}
    for qmode in ("f32", "f16", "int8"):
        frame = codec.encode_frame(codec.DraftPacket(0, 0, TOKS, draft_q=Q, qmode=qmode))
        sizes[qmode] = len(frame)
        mine, theirs = codec.decode_frame(frame)[0], jcodec.decode_frame(frame)[0]
        np.testing.assert_array_equal(mine.draft_q, theirs.draft_q)
        np.testing.assert_allclose(mine.draft_q, Q, atol=1e-2)
    assert sizes["int8"] < sizes["f16"] < sizes["f32"]


@settings(max_examples=60, deadline=None)
@given(
    dev=st.integers(0, 2**32 - 1),
    seq=st.integers(0, 2**32 - 1),
    toks=st.lists(st.integers(-(2**31), 2**31 - 1), max_size=40),
    qmode=st.sampled_from(codec.QMODES),
    qseed=st.integers(0, 2**16),
)
def test_draft_packet_property_matches_jax(dev, seq, toks, qmode, qseed):
    """The strategies of tests/test_transport.py::test_codec_property_roundtrip:
    the port's frame is the JAX frame and decodes to the same packet on
    both sides; an empty int8 packet makes both encoders raise ValueError."""
    toks = np.asarray(toks, np.int32)
    q = None
    if qmode != "none":
        q = np.random.default_rng(qseed).uniform(0, 1, size=len(toks)).astype(np.float32)
    if qmode == "int8" and toks.size == 0:
        with pytest.raises(ValueError):
            jcodec.encode_frame(jcodec.DraftPacket(dev, seq, toks, draft_q=q, qmode=qmode))
        with pytest.raises(codec.CodecError):
            codec.encode_frame(codec.DraftPacket(dev, seq, toks, draft_q=q, qmode=qmode))
        return
    frame = codec.encode_frame(codec.DraftPacket(dev, seq, toks, draft_q=q, qmode=qmode))
    assert frame == jcodec.encode_frame(jcodec.DraftPacket(dev, seq, toks, draft_q=q,
                                                           qmode=qmode))
    mine, theirs = codec.decode_frame(frame)[0], jcodec.decode_frame(frame)[0]
    _same(mine, theirs)
    assert (mine.device_id, mine.seq, mine.qmode) == (dev, seq, qmode)
    np.testing.assert_array_equal(mine.tokens, toks)
    if qmode != "none":
        np.testing.assert_allclose(mine.draft_q, q, atol=2e-2)


def test_frame_decoder_reassembles_a_stream_cut_anywhere():
    """The frames of every message, run together and cut in two at every
    offset: the decoder gives back every message, in order."""
    msgs = _messages(codec)
    frames = [codec.encode_frame(m) for m in msgs]
    stream = b"".join(frames)
    for cut in range(len(stream) + 1):
        dec = codec.FrameDecoder()
        got = []
        for part in (stream[:cut], stream[cut:]):
            dec.feed(part)
            got.extend(dec)
        assert [codec.encode_frame(m) for m in got] == frames, cut


def test_every_truncation_yields_no_frame():
    """A frame cut short at any length yields nothing from the decoder and
    raises CodecError from decode_frame."""
    for msg in _messages(codec):
        frame = codec.encode_frame(msg)
        for n in range(len(frame)):
            dec = codec.FrameDecoder()
            dec.feed(frame[:n])
            assert dec.next_raw() is None and list(dec) == []
            with pytest.raises(codec.CodecError):
                codec.decode_frame(frame[:n])


def test_control_plane_frames_are_refused():
    """Type ids 8-34 (the JAX package's control plane) were refused until
    the control plane was ported; now the JAX codec's Ping decodes to the
    port's, and only type ids past 34 are refused, as unknown
    (tests/test_torch_worker.py holds every control frame)."""
    frame = jcodec.encode_frame(jcodec.Ping(seq=1, t=0.5))
    msg, used = codec.decode_frame(frame)
    assert isinstance(msg, codec.Ping) and (msg.seq, msg.t, used) == (1, 0.5, len(frame))
    for mtype in (35, 99):
        bad = frame[:3] + bytes([mtype]) + frame[4:]
        with pytest.raises(codec.CodecError, match="unknown message type"):
            codec.decode_frame(bad)
