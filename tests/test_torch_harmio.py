"""The port's native dump parser (``models/harmio_native.py`` +
``csrc/harmio.cpp``) against numpy and the JAX package's binding (CPU).

* ``csrc/harmio.cpp`` is the JAX package's ``native/harmio.cpp`` byte for
  byte.
* The native parse of a torus dump's body (one thread: under 64 KiB; many:
  the 64x32 body) and of a text of awkward tokens equals the numpy parse
  and JAX ``harmio_native.parse_doubles``, bit for bit; ``read_dump`` goes
  through it by default and gives the numpy reader's model.
* A missing ``g++`` or a failed build raises, and leaves no library behind
  (the JAX reader would fall back to numpy silently).
"""

import hashlib
import os

import numpy as np
import pytest

from grmonty_tpu_torch.models import harm, harmio_native, torus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AWKWARD = ("1 -2.5 3e10 -4.25E-300 +5.0\n6.02214076e23\t7.\n.5 1e-320 "
           "0.1 0.30000000000000004 -0 123456789012345678901234567890\r\n")


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """(the 64x32 dump, its body text, an 8x4 dump's body text)."""
    d = tmp_path_factory.mktemp("dumps")
    out = []
    for n1, n2 in ((64, 32), (8, 4)):
        path = str(d / f"torus_{n1}x{n2}")
        torus.write_torus_dump(path, n1=n1, n2=n2)
        with open(path) as fh:
            fh.readline()
            out.append((path, fh.read()))
    return out[0][0], out[0][1], out[1][1]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_source_is_the_jax_packages():
    assert _sha(harmio_native.SRC) == _sha(os.path.join(ROOT, "native", "harmio.cpp"))


def test_native_parse_is_numpys_and_jaxs_to_the_bit(bodies):
    from grmonty_tpu.models import harmio_native as jharmio

    _, big, small = bodies
    assert len(big) > 1 << 16 > len(small)  # the threaded and the one-thread path
    for text in (big, small, AWKWARD):
        got = harmio_native.parse_doubles(text)
        want = np.array(text.split(), dtype=np.float64)
        assert got.dtype == np.float64 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == jharmio.parse_doubles(text).tobytes()


def test_read_dump_parses_natively_by_default(bodies, monkeypatch):
    path = bodies[0]
    calls = []
    orig = harmio_native.parse_doubles

    def spy(text):
        calls.append(len(text))
        return orig(text)

    monkeypatch.setattr(harmio_native, "parse_doubles", spy)
    m_nat = harm.read_dump(path, 4e19)
    assert len(calls) == 1
    m_np = harm.read_dump(path, 4e19, native=False)
    assert len(calls) == 1
    assert m_nat.data.stacked().tobytes() == m_np.data.stacked().tobytes()
    assert m_nat.bias_norm == m_np.bias_norm and m_nat.header == m_np.header


def test_raises_without_a_compiler_or_on_a_failed_build(bodies, tmp_path, monkeypatch):
    monkeypatch.setattr(harmio_native, "_lib", None)
    monkeypatch.setattr(harmio_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(harmio_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        harmio_native.parse_doubles("1 2 3")
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(harmio_native, "_lib", None)
    monkeypatch.setattr(harmio_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(harmio_native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        harm.read_dump(bodies[0], 4e19)
    assert not any(p.suffix in (".so", ".tmp") for p in tmp_path.iterdir())
