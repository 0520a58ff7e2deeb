"""The port's compile cache on the CPU, held to the JAX package's.

- ``stable_hash``: order-insensitive, content not identity (``__slots__``
  objects, torch tensors), the same in another process; a parser's
  ``executor_fingerprint`` the same in another process.
- ``CompileCache``: the reference's store cases -- disabled is inert, the
  round trip, and each refusal (bad magic, a truncated entry, a payload
  digest mismatch, a renamed key, backend drift), a warning once, a
  write failure that degrades to no cache -- each counted on
  ``compile_cache_errors_total{kind}`` as in the reference; the two
  packages' magics differ, so neither reads the other's entries.
- ``kernels.build()``'s resolution order (the build directory, the cache,
  ``nvcc``) and an artifact's installed libraries, driven by a stand-in
  ``nvcc`` that writes a placeholder library (no card, no toolkit here:
  nothing is loaded).
"""
import json
import logging
import os
import shutil
import stat
import struct
import subprocess
import sys

import pytest
import torch

from logparser_tpu.tpu import compile_cache as ref_cc
from logparser_tpu_torch.observability import metrics
from logparser_tpu_torch.tpu import compile_cache as cc
from logparser_tpu_torch.tpu import kernels
from logparser_tpu_torch.tpu.compile_cache import (
    _ENTRY_MAGIC,
    CompileCache,
    backend_fingerprint,
    stable_hash,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HASH_SAMPLE = {
    "fields": ("IP:connection.client.host", "BYTES:response.body.bytes"),
    "nested": {"b": [1, 2.5, None], "a": {"x", "y"}},
    "flag": True,
}


def _errors(kind: str) -> float:
    return metrics().get("compile_cache_errors_total", {"kind": kind})


# ---------------------------------------------------------------------------
# stable_hash and the parser fingerprint
# ---------------------------------------------------------------------------


def test_stable_hash_dict_order_insensitive():
    a = {"x": 1, "y": {"p": 2, "q": 3}}
    b = {"y": {"q": 3, "p": 2}, "x": 1}
    assert stable_hash(a) == stable_hash(b)
    assert stable_hash(a) != stable_hash({"x": 1, "y": {"p": 2, "q": 4}})


class _Slotted:
    __slots__ = ("tag", "tables")

    def __init__(self, tag, tables):
        self.tag = tag
        self.tables = tables


def test_stable_hash_is_content_not_identity():
    a = _Slotted("en", {"months": ("Jan", "Feb")})
    b = _Slotted("en", {"months": ("Jan", "Feb")})
    assert repr(a) != repr(b) and stable_hash(a) == stable_hash(b)
    assert stable_hash(a) != stable_hash(_Slotted("fr", {"months": ("Jan", "Feb")}))
    # Tensors hash by dtype, shape and bytes.
    t = torch.arange(6, dtype=torch.int32)
    assert stable_hash({"t": t}) == stable_hash({"t": t.clone()})
    assert stable_hash({"t": t}) != stable_hash({"t": t.reshape(2, 3)})
    assert stable_hash({"t": t}) != stable_hash({"t": t.to(torch.int64)})


def _in_subprocess(code: str, seed: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONHASHSEED": seed}, cwd=ROOT)
    return out.stdout.strip()


def test_stable_hash_and_fingerprint_across_processes():
    """PYTHONHASHSEED varies per process: set order and object hashes
    differ, so this catches any hash()-dependence.  The parser pulls a
    DeviceTimeLayout (locale tables) and a zone table into its plans."""
    from logparser_tpu_torch import TorchBatchParser

    fields = ["TIME.ZONE:request.receive.time.timezone", "IP:connection.client.host",
              "STRING:request.firstline.uri.query.*"]
    parser = TorchBatchParser("combined", fields, device="cpu")
    code = (
        "from logparser_tpu_torch import TorchBatchParser\n"
        "from logparser_tpu_torch.tpu.compile_cache import stable_hash\n"
        f"print(stable_hash({_HASH_SAMPLE!r}))\n"
        f"p = TorchBatchParser('combined', {fields!r}, device='cpu')\n"
        "print(p.executor_fingerprint()); print(p.executor_fingerprint(False))\n"
    )
    got = _in_subprocess(code, "12345").splitlines()
    assert got == [stable_hash(_HASH_SAMPLE), parser.executor_fingerprint(),
                   parser.executor_fingerprint(False)]
    assert parser.executor_fingerprint() != parser.executor_fingerprint(False)
    parser.parse_batch(["1.2.3.4 - - [01/Jan/2024:00:00:00 +0000] \"GET /?a=1 HTTP/1.0\" "
                        "200 5 \"-\" \"-\""] * 3)
    assert parser.executor_fingerprint() == got[1]   # a parse changes nothing
    parser._grow_csr_slots()
    assert parser.executor_fingerprint() != got[1]   # a regrow is a new plan


# ---------------------------------------------------------------------------
# CompileCache: the store and its refusals
# ---------------------------------------------------------------------------


def test_cache_disabled_is_inert(tmp_path):
    cache = CompileCache(None)
    assert not cache.enabled
    assert cache.get("00" * 20) is None
    assert cache.put("00" * 20, b"payload") is False
    assert list(tmp_path.iterdir()) == []


def test_cache_round_trip(tmp_path):
    cache = CompileCache(str(tmp_path))
    key = "ab" + "cd" * 19
    assert cache.get(key) is None
    assert cache.put(key, b"\x00\x01payload\xff", meta={"kernel": "split"})
    assert cache.get(key) == b"\x00\x01payload\xff"
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert [p.name for p in files] == [f"{key}.so.entry"]


def _rewrite(cache, key, mutate):
    path = cache._path(key)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(mutate(blob))


def _set_backend(blob):
    off = len(_ENTRY_MAGIC)
    (hlen,) = struct.unpack("<I", blob[off:off + 4])
    header = json.loads(blob[off + 4:off + 4 + hlen])
    assert header["backend"] == backend_fingerprint()
    header["backend"] = "arch=sm_90a;nvcc=V0.0;torch=0.0;cuda=0.0;device=another card"
    hdr = json.dumps(header, sort_keys=True).encode()
    return _ENTRY_MAGIC + struct.pack("<I", len(hdr)) + hdr + blob[off + 4 + hlen:]


def _flip_last(blob):
    return blob[:-1] + bytes([blob[-1] ^ 0xFF])


@pytest.mark.parametrize("kind,mutate", [
    ("magic", lambda blob: b"GARBAGE" + blob),
    ("corrupt", lambda blob: _ENTRY_MAGIC + struct.pack("<I", 10 ** 6)[:2]),
    ("digest", _flip_last),
    ("backend", _set_backend),
])
def test_cache_refuses_a_damaged_entry(tmp_path, kind, mutate):
    cache = CompileCache(str(tmp_path))
    key = "11" * 20
    cache.put(key, b"payload-bytes")
    _rewrite(cache, key, mutate)
    before = _errors(kind)
    assert cache.get(key) is None
    assert _errors(kind) == before + 1


def test_cache_refuses_a_renamed_key(tmp_path):
    cache = CompileCache(str(tmp_path))
    src, dst = "44" * 20, "55" * 20
    cache.put(src, b"payload")
    os.makedirs(os.path.dirname(cache._path(dst)), exist_ok=True)
    shutil.copy(cache._path(src), cache._path(dst))
    before = _errors("key_mismatch")
    assert cache.get(dst) is None
    assert _errors("key_mismatch") == before + 1


def test_cache_refusal_warns_once(tmp_path, caplog):
    cache = CompileCache(str(tmp_path))
    key = "77" * 20
    cache.put(key, b"payload")
    with open(cache._path(key), "wb") as f:
        f.write(b"not an entry at all")
    with caplog.at_level(logging.WARNING, logger="logparser_tpu_torch.tpu.compile_cache"):
        for _ in range(3):
            assert cache.get(key) is None
    assert len([r for r in caplog.records if "refused" in r.getMessage()]) == 1


def test_cache_write_failure_degrades(tmp_path):
    root = tmp_path / "blocked"
    root.write_text("a file where the cache directory should go")
    cache = CompileCache(str(root))
    before = _errors("io")
    assert cache.put("88" * 20, b"payload") is False
    assert _errors("io") == before + 1


def test_neither_package_reads_the_other_entries(tmp_path):
    assert _ENTRY_MAGIC != ref_cc._ENTRY_MAGIC
    key = "99" * 20
    ours, ref = CompileCache(str(tmp_path / "a")), ref_cc.CompileCache(str(tmp_path / "b"))
    ours.put(key, b"a library")
    ref.put(key, b"an executable")
    with open(ours._path(key), "rb") as f:
        our_blob = f.read()
    with open(ref._path(key), "rb") as f:
        ref_blob = f.read()
    with open(ours._path(key), "wb") as f:
        f.write(ref_blob)
    with open(ref._path(key), "wb") as f:
        f.write(our_blob)
    before = _errors("magic")
    assert ours.get(key) is None and _errors("magic") == before + 1
    assert ref.get(key) is None


def test_library_key_takes_every_component():
    base = cc.backend_components()
    keys = {cc.library_key("d", "split", base), cc.library_key("e", "split", base),
            cc.library_key("d", "muid", base)}
    for comp in base:
        keys.add(cc.library_key("d", "split", {**base, comp: "other"}))
    assert len(keys) == 3 + len(base)


# ---------------------------------------------------------------------------
# kernels.build(): the build directory, the cache, nvcc; artifacts
# ---------------------------------------------------------------------------


@pytest.fixture()
def toolkit(tmp_path, monkeypatch):
    """A copy of the kernel sources, a stand-in nvcc that logs its calls
    and writes a placeholder library, a cache directory, and a fresh
    per-process build record."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc, ignore=shutil.ignore_patterns("_build"))
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'if [ "$1" = "--version" ]; then\n'
        '  echo "Cuda compilation tools, release 12.4, V12.4.131"; exit 0\n'
        "fi\n"
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; out="$1"; fi; shift; done\n'
        'printf "placeholder library" > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv(cc.ENV_CACHE_DIR, str(tmp_path / "cache"))
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())

    def compiles():
        return [ln for ln in log.read_text().splitlines() if "--version" not in ln] \
            if log.exists() else []

    return csrc, compiles


def test_build_resolves_nvcc_then_the_build_dir_then_the_cache(toolkit, monkeypatch):
    csrc, compiles = toolkit
    assert kernels.source_digest() == kernels.source_digest()
    paths = kernels.build()
    assert set(kernels.build_info()["sources"].values()) == {"nvcc"}
    assert len(compiles()) == len(kernels.KERNELS)
    key = json.loads((kernels.build_dir() / "key.json").read_text())
    assert key == cc.backend_components() and key["nvcc"] == "V12.4.131"
    # A new process, the build directory intact: nothing compiles.
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    assert kernels.build() == paths
    assert set(kernels.build_info()["sources"].values()) == {"build_dir"}
    assert len(compiles()) == len(kernels.KERNELS)
    # An empty build directory: every library comes from the cache.
    shutil.rmtree(kernels.build_dir())
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    kernels.build()
    assert set(kernels.build_info()["sources"].values()) == {"cache"}
    assert len(compiles()) == len(kernels.KERNELS)
    # A directory built for another backend is discarded, never loaded.
    (kernels.build_dir() / "key.json").write_text(json.dumps({**key, "device": "another"}))
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    kernels.build()
    assert set(kernels.build_info()["sources"].values()) == {"cache"}
    # A source edit changes the digest: a fresh build.
    (csrc / "split.cu").write_text((csrc / "split.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    kernels.build()
    assert set(kernels.build_info()["sources"].values()) == {"nvcc"}
    assert len(compiles()) == 2 * len(kernels.KERNELS)


def test_artifact_libraries_install_only_on_a_matching_backend(toolkit, monkeypatch):
    csrc, compiles = toolkit
    assert kernels.library_blobs() is None   # nothing built yet
    kernels.build()
    blobs = kernels.library_blobs()
    assert set(blobs["libs"]) == set(kernels.KERNELS) and blobs["digest"] == kernels.source_digest()
    shutil.rmtree(kernels.build_dir())
    monkeypatch.delenv(cc.ENV_CACHE_DIR)
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    before = _errors("backend")
    assert not kernels.install_libraries({**blobs, "backend": {**blobs["backend"],
                                                               "torch": "0.0"}})
    assert _errors("backend") == before + 1
    before = _errors("digest")
    assert not kernels.install_libraries({**blobs, "digest": "0" * 16})
    assert _errors("digest") == before + 1
    assert kernels.install_libraries(blobs)
    kernels.build()
    assert set(kernels.build_info()["sources"].values()) == {"artifact"}
    assert len(compiles()) == len(kernels.KERNELS)   # nothing compiled again
    # A host without nvcc accepts the building host's nvcc for the same sources,
    # runtimes and card where its driver supports that toolkit's release.
    monkeypatch.setenv("CUDA_HOME", str(csrc / "no-such-toolkit"))
    monkeypatch.setenv("PATH", str(csrc / "no-such-bin"))
    monkeypatch.setattr(cc, "cuda_driver_version", lambda: (12, 4))
    assert cc.backend_components()["nvcc"] is None
    assert cc.backend_matches(blobs["backend"])
    assert not cc.backend_matches({**blobs["backend"], "cuda": "0.0"})
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels._nvcc()


@pytest.mark.parametrize("recorded_nvcc,driver", [
    ("V12.8.61", (12, 4)),     # a newer toolkit than the driver supports
    ("V13.0.48", (12, 9)),
    (None, (12, 4)),           # a toolkit nobody recorded
    ("unknown", (12, 4)),
    ("V12.4.131", None),       # no driver at all
])
def test_a_host_without_nvcc_refuses_a_library_its_driver_cannot_run(
        toolkit, monkeypatch, recorded_nvcc, driver):
    """The nvcc component is compared on a host that has none too: held to
    the CUDA release the host's driver supports.  A mismatch is a miss
    counted as backend drift, never a library that fails at load."""
    csrc, _ = toolkit
    kernels.build()
    blobs = kernels.library_blobs()
    shutil.rmtree(kernels.build_dir())
    monkeypatch.delenv(cc.ENV_CACHE_DIR)
    monkeypatch.setenv("CUDA_HOME", str(csrc / "no-such-toolkit"))
    monkeypatch.setenv("PATH", str(csrc / "no-such-bin"))
    monkeypatch.setattr(cc, "cuda_driver_version", lambda: driver)
    monkeypatch.setattr(kernels, "_BUILD", kernels._Build())
    backend = {**blobs["backend"], "nvcc": recorded_nvcc}
    assert not cc.backend_matches(backend)
    before = _errors("backend")
    assert not kernels.install_libraries({**blobs, "backend": backend})
    assert _errors("backend") == before + 1
    # The same set in a build directory is discarded, counted, never loaded.
    kernels.build_dir().mkdir(parents=True)
    for k, blob in blobs["libs"].items():
        (kernels.build_dir() / f"lib{k}.so").write_bytes(blob)
    (kernels.build_dir() / "key.json").write_text(json.dumps(backend))
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.build()
    assert _errors("backend") == before + 2
    assert not any(kernels.build_dir().glob("lib*.so"))


def test_nvcc_release_and_the_driver_version():
    assert cc.nvcc_release("V12.4.131") == (12, 4)
    assert cc.nvcc_release("12.8") == (12, 8)
    assert cc.nvcc_release(None) is None and cc.nvcc_release("unknown") is None
    driver = cc.cuda_driver_version()
    assert driver is None or (len(driver) == 2 and driver[0] >= 1)
