"""Corpus builder CLI: raw text -> packed token shards + index (a copy of
``repro/data/build_corpus.py``; both write the same bytes).

    PYTHONPATH=src python -m repro_torch.data.build_corpus \
        --input 'tests/fixtures/corpus/*.txt' --out /tmp/corpus \
        --tokenizer bpe --vocab 512 [--eval-fraction 0.05] [--verify]

Reads every file matching the glob (sorted, so the stream is
deterministic), joins documents with a blank line, trains the tokenizer
(``bpe``) or uses the fixed byte alphabet (``byte``), tokenizes, and
writes the shard store (see ``repro_torch.data.store``).  ``--verify`` re-opens
the result, checks the content hash and a decode round-trip, and prints
the stats the smoke gate greps for.
"""

from __future__ import annotations

import argparse
import glob as globlib
import sys

import numpy as np

from repro_torch.data import store as store_lib
from repro_torch.data.tokenizer import make_tokenizer

DOC_SEP = "\n\n"


def read_documents(pattern: str) -> list:
    paths = sorted(globlib.glob(pattern, recursive=True))
    if not paths:
        raise FileNotFoundError(f"no files match {pattern!r}")
    docs = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            docs.append(f.read())
    return docs


def build(pattern: str, out_dir: str, *, tokenizer_kind: str = "bpe",
          vocab_size: int = 512, eval_fraction: float = 0.05,
          shard_tokens: int = 1 << 22) -> dict:
    """Library entry point (the CLI, the tests and chip_smoke.py call this)."""
    docs = read_documents(pattern)
    text = DOC_SEP.join(docs)
    tok = make_tokenizer(tokenizer_kind, texts=docs, vocab_size=vocab_size)
    tokens = tok.encode(text)
    return store_lib.write_corpus(out_dir, np.asarray(tokens), tok,
                                  shard_tokens=shard_tokens,
                                  eval_fraction=eval_fraction,
                                  source_desc=pattern)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="glob of raw UTF-8 text files (sorted -> "
                         "deterministic stream)")
    ap.add_argument("--out", required=True, help="corpus directory to write")
    ap.add_argument("--tokenizer", default="bpe", choices=["byte", "bpe"])
    ap.add_argument("--vocab", type=int, default=512,
                    help="BPE target vocab (>= 256; ignored for byte)")
    ap.add_argument("--eval-fraction", type=float, default=0.05,
                    help="held-out tail fraction of the token stream")
    ap.add_argument("--shard-tokens", type=int, default=1 << 22)
    ap.add_argument("--verify", action="store_true",
                    help="re-open, check hash + decode round-trip")
    args = ap.parse_args(argv)

    index = build(args.input, args.out, tokenizer_kind=args.tokenizer,
                  vocab_size=args.vocab, eval_fraction=args.eval_fraction,
                  shard_tokens=args.shard_tokens)
    tr = index["splits"]["train"]["n_tokens"]
    ev = index["splits"]["eval"]["n_tokens"]
    print(f"corpus: {args.out} vocab={index['vocab_size']} "
          f"dtype={index['dtype']} train_tokens={tr} eval_tokens={ev} "
          f"hash={index['corpus_hash'][:12]}")
    if args.verify:
        st = store_lib.TokenStore(args.out)
        ok = st.verify_hash()
        toks = np.concatenate([st.split("train").tokens(),
                               st.split("eval").tokens()])
        text = DOC_SEP.join(read_documents(args.input))
        roundtrip = st.tokenizer.decode(toks) == text
        print(f"verify: hash={'ok' if ok else 'MISMATCH'} "
              f"roundtrip={'ok' if roundtrip else 'MISMATCH'}")
        if not (ok and roundtrip):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
