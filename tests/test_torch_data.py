"""The port's data subsystem (``repro_torch.data``) against ``repro.data``
on the CPU: corpora built by both packages are equal byte for byte, and
every source's batch ``i`` is bitwise the reference's batch ``i``, through
the thread prefetcher and through worker processes alike.  No tolerance:
everything here is integer data.

Each corpus is built once per session by each package (the BPE-512 fixture
corpus of ``tests/fixtures/corpus/`` and a byte corpus of the same text).
"""

import filecmp
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import build_corpus as jbuild
from repro.data import pipeline as jpipe
from repro.data.order import SampleOrder as JaxSampleOrder
from repro.data.store import TokenStore as JaxTokenStore
from repro.data.store import write_corpus as jax_write_corpus
from repro.data.tokenizer import BPETokenizer as JaxBPE
from repro_torch.data import build_corpus, pipeline
from repro_torch.data.order import SampleOrder
from repro_torch.data.pipeline import (ByteLM, CorpusLM, Prefetcher,
                                       TokenizingTextLM, make_source)
from repro_torch.data.store import TokenStore, write_corpus
from repro_torch.data.tokenizer import (BPETokenizer, ByteTokenizer,
                                        make_tokenizer, tokenizer_from_json)
from repro_torch.data.workers import ProcessPrefetcher

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_GLOB = os.path.join(REPO, "tests", "fixtures", "corpus", "*.txt")


def _build_both(tmp_path_factory, kind):
    port = tmp_path_factory.mktemp(f"port_{kind}")
    ref = tmp_path_factory.mktemp(f"jax_{kind}")
    build_corpus.build(FIXTURE_GLOB, str(port), tokenizer_kind=kind,
                       vocab_size=512, eval_fraction=0.05)
    jbuild.build(FIXTURE_GLOB, str(ref), tokenizer_kind=kind,
                 vocab_size=512, eval_fraction=0.05)
    return str(port), str(ref)


@pytest.fixture(scope="session")
def bpe_dirs(tmp_path_factory):
    """(port, reference) builds of the BPE-512 fixture corpus."""
    return _build_both(tmp_path_factory, "bpe")


@pytest.fixture(scope="session")
def byte_dirs(tmp_path_factory):
    """(port, reference) builds of the byte-tokenized fixture corpus."""
    return _build_both(tmp_path_factory, "byte")


def _equal_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Tokenizers and the corpus store
# ---------------------------------------------------------------------------

def test_bpe_merges_and_hash_are_the_reference():
    docs = jbuild.read_documents(FIXTURE_GLOB)
    tok = BPETokenizer.train(docs, vocab_size=384)
    ref = JaxBPE.train(docs, vocab_size=384)
    assert tok.merges == ref.merges
    assert tok.config_hash() == ref.config_hash()
    text = build_corpus.DOC_SEP.join(docs)
    ids = tok.encode(text)
    np.testing.assert_array_equal(ids, ref.encode(text))
    assert ids.dtype == np.uint16
    assert tok.decode(ids) == text
    again = tokenizer_from_json(tok.to_json())
    assert again.merges == tok.merges


def test_byte_tokenizer_and_factory():
    tok = make_tokenizer("byte")
    assert isinstance(tok, ByteTokenizer) and tok.vocab_size == 256
    text = "wavelet subspaces, compact optimizer states — ü\n"
    assert tok.decode(tok.encode(text)) == text
    with pytest.raises(ValueError, match="unknown tokenizer"):
        make_tokenizer("wordpiece")
    with pytest.raises(ValueError, match="< 256"):
        BPETokenizer.train(["abc"], vocab_size=100)


@pytest.mark.parametrize("kind", ["bpe", "byte"])
def test_corpus_bytes_equal_the_reference(kind, bpe_dirs, byte_dirs):
    """Index, tokenizer state and every shard are byte-for-byte the JAX
    package's build of the same text, ``corpus_hash`` included; the hash
    verifies against the bytes on disk and the split sizes are the ones
    the fixture gives."""
    port, ref = bpe_dirs if kind == "bpe" else byte_dirs
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name),
                           shallow=False), name
    st = TokenStore(port)
    assert st.corpus_hash == JaxTokenStore(ref).corpus_hash
    assert st.verify_hash()
    sizes = {s: st.split(s).n_tokens for s in ("train", "eval")}
    assert sizes == ({"train": 5788, "eval": 304} if kind == "bpe"
                     else {"train": 13597, "eval": 715})


def test_corpus_roundtrip_and_windows_at_seq_256(bpe_dirs, byte_dirs):
    """The decode of both splits is the fixture text; at seq 256 the BPE
    corpus has 22 train windows and 1 eval window, the byte corpus 53 and
    2."""
    text = build_corpus.DOC_SEP.join(build_corpus.read_documents(
        FIXTURE_GLOB))
    want = {bpe_dirs[0]: (22, 1), byte_dirs[0]: (53, 2)}
    for d, (n_train, n_eval) in want.items():
        st = TokenStore(d)
        toks = np.concatenate([st.split("train").tokens(),
                               st.split("eval").tokens()])
        assert st.tokenizer.decode(toks) == text
        assert st.split("train").n_windows(256) == n_train
        assert st.split("eval").n_windows(256) == n_eval


def test_multi_shard_windows_equal_the_reference(tmp_path):
    """A forced multi-shard layout: the same shard files and the same
    window gather as the reference, and an out-of-range window raises."""
    stream = (np.arange(1000) % 251).astype(np.uint16)
    write_corpus(str(tmp_path / "p"), stream, ByteTokenizer(),
                 shard_tokens=137, eval_fraction=0.1)
    from repro.data.tokenizer import ByteTokenizer as JaxByte
    jax_write_corpus(str(tmp_path / "j"), stream, JaxByte(),
                     shard_tokens=137, eval_fraction=0.1)
    for name in sorted(os.listdir(tmp_path / "j")):
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "j" / name,
                           shallow=False), name
    view = TokenStore(str(tmp_path / "p")).split("train")
    jview = JaxTokenStore(str(tmp_path / "j")).split("train")
    n = view.n_windows(16)
    assert n == jview.n_windows(16) > 7
    idx = np.arange(n)[::-1]
    np.testing.assert_array_equal(view.windows(idx, 16),
                                  jview.windows(idx, 16))
    with pytest.raises(IndexError):
        view.window(n, 16)


def test_split_view_pickles_without_its_maps(bpe_dirs):
    """Worker processes receive the store by pickle: the memmaps are
    dropped and reopened lazily, with the same windows."""
    st = TokenStore(bpe_dirs[0])
    view = st.split("train")
    want = view.windows(np.arange(5), 32)
    assert view._maps is not None
    clone = pickle.loads(pickle.dumps(view))
    assert clone._maps is None
    np.testing.assert_array_equal(clone.windows(np.arange(5), 32), want)
    assert pickle.loads(pickle.dumps(st))._views == {}


def test_build_corpus_cli_verifies(tmp_path, capsys):
    out = str(tmp_path / "c")
    assert build_corpus.main(["--input", FIXTURE_GLOB, "--out", out,
                              "--tokenizer", "byte", "--verify"]) == 0
    said = capsys.readouterr().out
    assert "verify: hash=ok roundtrip=ok" in said
    assert TokenStore(out).corpus_hash[:12] in said


# ---------------------------------------------------------------------------
# Sample order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(1, 0), (7, 3), (22, 0), (180, 5),
                                    (1000, 42), (1571, 0)])
def test_sample_order_is_the_reference(n, seed):
    """Three epochs of the seeded Feistel order equal the reference's, and
    each epoch is a permutation."""
    samples = np.arange(3 * n, dtype=np.int64)
    got = SampleOrder(n, seed).windows(samples)
    np.testing.assert_array_equal(got, JaxSampleOrder(n, seed)
                                  .windows(samples))
    for e in range(3):
        assert sorted(got[e * n:(e + 1) * n].tolist()) == list(range(n))
    assert SampleOrder(n, seed).epoch_of(2 * n) == 2


def test_sample_order_refuses_empty_and_negative():
    with pytest.raises(ValueError, match="positive"):
        SampleOrder(0)
    with pytest.raises(ValueError, match="non-negative"):
        SampleOrder(5).windows(np.asarray([-1]))


# ---------------------------------------------------------------------------
# Sources: batch i is the reference's batch i
# ---------------------------------------------------------------------------

# at seq 32 and batch 4 the BPE corpus holds 180 train windows: 45 batches
# an epoch, so 44-46 cross the first epoch's end
INDICES = (0, 7, 44, 45, 46, 1000)


@pytest.mark.parametrize("seed", [0, 5])
def test_corpus_batches_are_the_reference(bpe_dirs, seed):
    port, ref = bpe_dirs
    src = CorpusLM(port, 32, 4, seed=seed)
    jsrc = jpipe.CorpusLM(ref, 32, 4, seed=seed)
    assert src.n_windows == jsrc.n_windows == 180
    for i in INDICES:
        b = src.batch(i)
        _equal_batches(b, jsrc.batch(i))
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_corpus_dp_slices_compose(bpe_dirs):
    port, ref = bpe_dirs
    full = CorpusLM(port, 32, 8, seed=0).batch(23)
    for H in (2, 4):
        parts = [CorpusLM(port, 32, 8, seed=0, dp_rank=r,
                          dp_size=H).batch(23) for r in range(H)]
        _equal_batches({k: np.concatenate([p[k] for p in parts])
                        for k in full}, full)
        _equal_batches(parts[-1], jpipe.CorpusLM(
            ref, 32, 8, seed=0, dp_rank=H - 1, dp_size=H).batch(23))
    with pytest.raises(ValueError, match="not divisible"):
        CorpusLM(port, 32, 6, dp_size=4)
    with pytest.raises(ValueError, match="outside"):
        CorpusLM(port, 32, 8, dp_rank=4, dp_size=4)


@pytest.mark.parametrize("kind,vocab", [("synthetic", 64), ("bytes", 64),
                                        ("bytes", 32000), ("corpus", 512)])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_make_source_is_the_reference(bpe_dirs, kind, vocab, split):
    """``make_source`` of each kind, train and eval split (a disjoint seed
    stream for synthetic and bytes, the sequential eval windows of the
    corpus), gives the reference's batches."""
    port, ref = bpe_dirs
    kw = dict(seed=3, split=split, pattern=FIXTURE_GLOB)
    src = make_source(kind, vocab, 32, 4, corpus_dir=port, **kw)
    jsrc = jpipe.make_source(kind, vocab, 32, 4, corpus_dir=ref, **kw)
    assert type(src).__name__ == type(jsrc).__name__
    for i in INDICES:
        _equal_batches(src.batch(i), jsrc.batch(i))
    if kind == "corpus" and split == "eval":
        assert src.order is None and src.n_windows == 9


def test_eval_stream_is_disjoint_from_train():
    a = make_source("synthetic", 64, 16, 4, seed=0).batch(0)
    b = make_source("synthetic", 64, 16, 4, seed=0, split="eval").batch(0)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_byte_and_tokenizing_sources_are_the_reference():
    byte = ByteLM(FIXTURE_GLOB, 32, 4, seed=2, vocab=256)
    jbyte = jpipe.ByteLM(FIXTURE_GLOB, 32, 4, seed=2, vocab=256)
    docs = jbuild.read_documents(FIXTURE_GLOB)
    text = build_corpus.DOC_SEP.join(docs)
    tok = BPETokenizer.train(docs, vocab_size=300)
    tsrc = TokenizingTextLM(text, tok, 16, 4, seed=2)
    jtsrc = jpipe.TokenizingTextLM(text, JaxBPE.train(docs, 300), 16, 4,
                                   seed=2)
    for i in INDICES:
        _equal_batches(byte.batch(i), jbyte.batch(i))
        _equal_batches(tsrc.batch(i), jtsrc.batch(i))
    with pytest.raises(FileNotFoundError):
        ByteLM(os.path.join(REPO, "no_such_dir", "*.txt"), 32, 4)
    with pytest.raises(ValueError, match="too short"):
        TokenizingTextLM("short", tok, 16, 4)


def test_make_source_refusals_are_the_reference(bpe_dirs):
    """The vocab guard, a corpus kind without a directory, an unknown kind;
    and encoder frames, which the port does not have yet."""
    port, ref = bpe_dirs
    for mod, d in ((pipeline, port), (jpipe, ref)):
        with pytest.raises(ValueError, match="exceeds model vocab 256"):
            mod.make_source("corpus", 256, 32, 4, corpus_dir=d)
        with pytest.raises(ValueError, match="needs corpus_dir"):
            mod.make_source("corpus", 512, 32, 4)
        with pytest.raises(ValueError, match="unknown data source"):
            mod.make_source("c4", 512, 32, 4)
        with pytest.raises(ValueError, match="no seq_len=8192 windows"):
            mod.make_source("corpus", 512, 8192, 4, corpus_dir=d)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        make_source("synthetic", 64, 32, 4, enc_frames=8, enc_dim=32)


def test_stack_batches_is_the_reference():
    src = make_source("synthetic", 64, 16, 4, seed=1)
    bs = [src.batch(i) for i in range(3)]
    got = pipeline.stack_batches(bs)
    _equal_batches(got, jpipe.stack_batches(bs))
    assert got["tokens"].shape == (3, 4, 16)


# ---------------------------------------------------------------------------
# Prefetch: thread and worker processes
# ---------------------------------------------------------------------------

class FailsAt:
    """A source whose ``batch(fail_at)`` raises (module level: workers
    unpickle it)."""
    batch_size = 2

    def __init__(self, fail_at=3):
        self.fail_at = fail_at

    def batch(self, i):
        if i == self.fail_at:
            raise ValueError(f"boom at {i}")
        return {"x": np.full((2, 4), i, np.int32)}


def _stream(pf, n):
    return [next(pf) for _ in range(n)]


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_prefetch_equals_direct_batches(bpe_dirs, workers):
    """From a nonzero start step, the thread prefetcher and 1 or 2 worker
    processes yield exactly ``start, start+1, ...`` with the direct
    ``batch(i)``, bitwise."""
    src = CorpusLM(bpe_dirs[0], 32, 4, seed=1)
    start = 43
    pf = Prefetcher(src, start_step=start, depth=4) if workers == 0 \
        else ProcessPrefetcher(src, start_step=start, depth=4,
                               num_workers=workers)
    with pf:
        got = _stream(pf, 6)
    assert [i for i, _ in got] == list(range(start, start + 6))
    for i, b in got:
        _equal_batches(b, src.batch(i))


def test_prefetcher_reraises_source_error_and_close_joins():
    pf = Prefetcher(FailsAt(3), depth=2)
    got = []
    with pytest.raises(ValueError, match="boom at 3"):
        for _ in range(10):
            got.append(next(pf)[0])
    assert got == [0, 1, 2]          # batches before the failure drain
    with pytest.raises(ValueError):  # re-raises, never hangs
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    live = Prefetcher(FailsAt(10**9), depth=1)
    next(live)
    live.close()
    assert not live._thread.is_alive()


def test_process_prefetcher_reraises_worker_error_and_close_joins():
    pp = ProcessPrefetcher(FailsAt(2), depth=4, num_workers=2)
    got = []
    try:
        with pytest.raises(ValueError, match="boom at 2"):
            for _ in range(8):
                got.append(next(pp)[0])
        assert got == [0, 1]
    finally:
        pp.close()
    assert not any(p.is_alive() for p in pp._procs)
    with pytest.raises(ValueError, match="num_workers"):
        ProcessPrefetcher(FailsAt(), num_workers=0)


def test_data_modules_import_no_torch():
    """Spawned workers import these modules; none may pull torch in."""
    code = ("import sys\n"
            "import repro_torch.data.pipeline, repro_torch.data.workers, "
            "repro_torch.data.store, repro_torch.data.order, "
            "repro_torch.data.tokenizer, repro_torch.data.build_corpus\n"
            "print('TORCH', 'torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH="src"))
    assert r.returncode == 0, r.stderr
    assert "TORCH False" in r.stdout, r.stdout + r.stderr
