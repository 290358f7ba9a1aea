"""Text datasets (parity: python/paddle/text/datasets/*.py; port of
paddle_tpu/text/datasets.py).

The port never downloads: each dataset reads the reference's standard archive format
from a local path (default: the reference's download-cache location
~/.cache/paddle/dataset); ``FakeTextDataset`` supplies synthetic token
streams for tests and benchmarks.
"""
from __future__ import annotations

import os
import re
import tarfile
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.io.dataset_cache import CACHE_ROOT as _CACHE, require_file

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16",
           "Conll05st", "FakeTextDataset"]


def _need(path, name):
    return require_file(name, path)


class Imdb(Dataset):
    """IMDB sentiment (reference: text/datasets/imdb.py; aclImdb_v1 tar)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, word_idx: Optional[dict] = None):
        self.mode = mode
        data_file = data_file or os.path.join(_CACHE, "imdb",
                                              "aclImdb_v1.tar.gz")
        _need(data_file, "Imdb")
        # vocab is built over train+test (reference imdb.py _build_work_dict
        # scans aclImdb/((train)|(test))/...), so both modes share ids.  A
        # caller-supplied word_idx (the 1.x reader-creator contract, where
        # imdb.train(word_idx) tokenizes with the dict the caller built)
        # skips the freq pass and is used verbatim.
        vocab_pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        mode_pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        docs, labels = [], []
        freq = {}
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                vm = vocab_pat.match(member.name)
                if not vm:
                    continue
                if word_idx is not None and not mode_pat.match(member.name):
                    continue
                text = tf.extractfile(member).read().decode(
                    "utf-8", "ignore").lower()
                words = re.sub(r"[^a-z]+", " ", text).split()
                if word_idx is None:
                    for w in words:
                        freq[w] = freq.get(w, 0) + 1
                if mode_pat.match(member.name):
                    docs.append(words)
                    labels.append(0 if vm.group(2) == "pos" else 1)
        if word_idx is not None:
            self.word_idx = dict(word_idx)
        else:
            kept = [w for w, c in sorted(freq.items(),
                                         key=lambda kv: (-kv[1], kv[0]))
                    if c > cutoff]  # reference keeps freq > cutoff
            self.word_idx = {w: i for i, w in enumerate(kept)}
            self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in d],
                                np.int64) for d in docs]
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB n-gram LM dataset (reference: text/datasets/imikolov.py)."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50,
                 word_idx: Optional[dict] = None):
        data_file = data_file or os.path.join(
            _CACHE, "imikolov", "simple-examples.tgz")
        _need(data_file, "Imikolov")
        member = {"train": "./simple-examples/data/ptb.train.txt",
                  "test": "./simple-examples/data/ptb.valid.txt"}[mode]
        with tarfile.open(data_file) as tf:
            if word_idx is None:
                freq = {}
                train = tf.extractfile(
                    "./simple-examples/data/ptb.train.txt").read().decode()
                for w in train.split():
                    freq[w] = freq.get(w, 0) + 1
            text = tf.extractfile(member).read().decode()
        if word_idx is not None:
            # 1.x reader-creator contract: ids come from the dict the
            # caller built (possibly with a non-default min_word_freq)
            self.word_idx = dict(word_idx)
        else:
            # reference build_dict keeps strictly freq > min_word_freq
            vocab = [w for w, c in sorted(freq.items(),
                                          key=lambda kv: (-kv[1], kv[0]))
                     if c > min_word_freq and w != "<unk>"]
            self.word_idx = {w: i for i, w in enumerate(vocab)}
            self.word_idx["<unk>"] = len(self.word_idx)
            self.word_idx["<s>"] = len(self.word_idx)
            self.word_idx["<e>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data = []
        for line in text.split("\n"):
            words = (["<s>"] + line.split() + ["<e>"])
            ids = [self.word_idx.get(w, unk) for w in words]
            if data_type.upper() == "NGRAM":
                for i in range(len(ids) - window_size + 1):
                    self.data.append(np.asarray(ids[i:i + window_size],
                                                np.int64))
            else:
                self.data.append(np.asarray(ids, np.int64))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """Boston housing regression (reference: text/datasets/uci_housing.py;
    reads the standard housing.data whitespace table)."""

    FEATURE_NUM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train"):
        data_file = data_file or os.path.join(_CACHE, "uci_housing",
                                              "housing.data")
        _need(data_file, "UCIHousing")
        raw = np.loadtxt(data_file).astype(np.float32)
        feats = raw[:, :-1]
        mn, mx = feats.min(0), feats.max(0)
        feats = (feats - feats.mean(0)) / np.maximum(mx - mn, 1e-6)
        split = int(len(raw) * 0.8)
        sl = slice(0, split) if mode == "train" else slice(split, None)
        self.data = feats[sl]
        self.targets = raw[sl, -1:].astype(np.float32)

    def __getitem__(self, idx):
        return self.data[idx], self.targets[idx]

    def __len__(self):
        return len(self.data)


_ML_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]   # movielens.py:31


class Movielens(Dataset):
    """MovieLens ml-1m ratings (reference: text/datasets/movielens.py).

    Sample (movielens.py _load_data): ([uid], [gender], [age_idx], [job],
    [mov_id], [category_ids...], [title_word_ids...], [rating*2-5]).
    Train/test split by the same seeded-random 0.1 holdout."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        import zipfile
        self.mode = mode
        data_file = data_file or os.path.join(_CACHE, "movielens",
                                              "ml-1m.zip")
        _need(data_file, "Movielens")
        self.categories_dict = {}
        self.movie_title_dict = {}
        movie_info = {}
        user_info = {}
        with zipfile.ZipFile(data_file) as z:
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = line.decode("latin1").strip() \
                        .split("::")
                    title_words = title.split()
                    for c in cats.split("|"):
                        self.categories_dict.setdefault(
                            c, len(self.categories_dict))
                    for w in title_words:
                        self.movie_title_dict.setdefault(
                            w.lower(), len(self.movie_title_dict))
                    movie_info[int(mid)] = (int(mid), cats.split("|"),
                                            title_words)
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _zip = line.decode(
                        "latin1").strip().split("::")
                    user_info[int(uid)] = (
                        int(uid), 0 if gender == "M" else 1,
                        _ML_AGE_TABLE.index(int(age)), int(job))
            rng = np.random.RandomState(rand_seed)
            is_test = mode == "test"
            self.data = []
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rng.random_sample() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ts = line.decode(
                        "latin1").strip().split("::")
                    u = user_info[int(uid)]
                    m = movie_info[int(mid)]
                    self.data.append((
                        [u[0]], [u[1]], [u[2]], [u[3]], [m[0]],
                        [self.categories_dict[c] for c in m[1]],
                        [self.movie_title_dict[w.lower()] for w in m[2]],
                        [float(rating) * 2 - 5.0]))

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


_WMT_START, _WMT_END, _WMT_UNK, _WMT_UNK_IDX = "<s>", "<e>", "<unk>", 2


class WMT14(Dataset):
    """WMT14 en→fr subset (reference: text/datasets/wmt14.py).

    Archive layout: ``*src.dict``/``*trg.dict`` vocab files plus
    ``{mode}/{mode}`` parallel files of ``src\\ttrg`` lines.  Samples
    (wmt14.py:158-166): (<s> src <e> ids, <s>+trg ids, trg+<e> ids),
    sequences longer than 80 dropped."""

    def __init__(self, data_file=None, mode="train", dict_size=-1):
        assert mode in ("train", "test", "gen"), mode
        self.mode = mode
        data_file = data_file or os.path.join(_CACHE, "wmt14", "wmt14.tgz")
        _need(data_file, "WMT14")
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(data_file) as tf:
            def to_dict(name):
                members = [m for m in tf.getmembers()
                           if m.name.endswith(name)]
                assert len(members) == 1, name
                out = {}
                for i, line in enumerate(tf.extractfile(members[0])):
                    if dict_size > 0 and i >= dict_size:
                        break
                    out[line.decode("utf-8").strip()] = i
                return out
            self.src_dict = to_dict("src.dict")
            self.trg_dict = to_dict("trg.dict")
            fname = f"{mode}/{mode}"
            for m in tf.getmembers():
                if not m.name.endswith(fname):
                    continue
                for line in tf.extractfile(m):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, _WMT_UNK_IDX) for w in
                           [_WMT_START] + parts[0].split() + [_WMT_END]]
                    trg = [self.trg_dict.get(w, _WMT_UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(src)
                    self.trg_ids.append(
                        [self.trg_dict[_WMT_START]] + trg)
                    self.trg_ids_next.append(
                        trg + [self.trg_dict[_WMT_END]])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(Dataset):
    """WMT16 en↔de (reference: text/datasets/wmt16.py): tarball with
    ``wmt16/{train,val,test}`` files of ``en\\tde`` lines; vocabularies
    built from the train corpus (top-k by frequency, after <s>/<e>/<unk>).
    """

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en"):
        assert mode in ("train", "test", "val"), mode
        self.mode = mode
        self.lang = lang
        data_file = data_file or os.path.join(_CACHE, "wmt16",
                                              "wmt16.tar.gz")
        _need(data_file, "WMT16")
        src_col = 0 if lang == "en" else 1
        trg_col = 1 - src_col
        with tarfile.open(data_file) as tf:
            def build_dict(col, size):
                freq = {}
                for line in tf.extractfile("wmt16/train"):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    for w in parts[col].split():
                        freq[w] = freq.get(w, 0) + 1
                words = sorted(freq, key=lambda w: (-freq[w], w))
                if size > 0:
                    words = words[:max(0, size - 3)]
                d = {_WMT_START: 0, _WMT_END: 1, _WMT_UNK: 2}
                for w in words:
                    d[w] = len(d)
                return d
            self.src_dict = build_dict(src_col, src_dict_size)
            self.trg_dict = build_dict(trg_col, trg_dict_size)
            self.data = []
            for line in tf.extractfile(f"wmt16/{mode}"):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [self.src_dict.get(w, _WMT_UNK_IDX)
                       for w in parts[src_col].split()]
                trg = [self.trg_dict.get(w, _WMT_UNK_IDX)
                       for w in parts[trg_col].split()]
                self.data.append((
                    [0] + src + [1], [0] + trg, trg + [1]))

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """CoNLL-2005 SRL test set (reference: text/datasets/conll05.py).

    Parses ``test.wsj.words.gz`` + ``test.wsj.props.gz`` star-bracket
    annotations into per-predicate samples (conll05.py:288):
    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2 — each repeated to
    sentence length — predicate_id, mark, BIO label_ids).  Word/verb/label
    dictionaries are built from the corpus when the reference's separate
    dict files are absent."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, **kw):
        import gzip
        data_file = data_file or os.path.join(_CACHE, "conll05st",
                                              "conll05st-tests.tar.gz")
        _need(data_file, "Conll05st")
        sentences, predicates, labels = [], [], []
        with tarfile.open(data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words_f, \
                    gzip.GzipFile(fileobj=pf) as props_f:
                one_seg, sent = [], []
                for wline, pline in zip(words_f, props_f):
                    word = wline.decode("utf-8").strip()
                    cols = pline.decode("utf-8").strip().split()
                    if not cols:                  # sentence boundary
                        self._flush(sent, one_seg, sentences, predicates,
                                    labels)
                        one_seg, sent = [], []
                        continue
                    sent.append(word)
                    one_seg.append(cols)
                self._flush(sent, one_seg, sentences, predicates, labels)

        def load_dict(path, items):
            if path and os.path.exists(path):
                with open(path) as f:
                    return {w.strip(): i for i, w in enumerate(f)}
            vocab = {}
            for it in items:
                for w in (it if isinstance(it, list) else [it]):
                    vocab.setdefault(w, len(vocab))
            return vocab

        self.word_dict = load_dict(word_dict_file, sentences + [["bos",
                                                                 "eos"]])
        self.predicate_dict = load_dict(verb_dict_file, predicates)
        self.label_dict = load_dict(target_dict_file, labels)
        self._samples = list(zip(sentences, predicates, labels))

    @staticmethod
    def _flush(sent, one_seg, sentences, predicates, labels):
        """conll05.py:190-236: column 0 is the predicate lemma column;
        each further column is one predicate's star-bracket tag sequence."""
        if not one_seg:
            return
        cols = [[row[i] for row in one_seg]
                for i in range(len(one_seg[0]))]
        verbs = [v for v in cols[0] if v != "-"]
        for i, col in enumerate(cols[1:]):
            seq, cur, inside = [], "O", False
            for tag in col:
                if tag == "*":
                    seq.append("I-" + cur if inside else "O")
                elif tag == "*)":
                    seq.append("I-" + cur)
                    inside = False
                elif "(" in tag:
                    cur = tag[1:tag.find("*")]
                    seq.append("B-" + cur)
                    inside = ")" not in tag
                else:
                    raise RuntimeError(f"unexpected SRL tag {tag}")
            if i < len(verbs):
                sentences.append(list(sent))
                predicates.append(verbs[i])
                labels.append(seq)

    def __getitem__(self, idx):
        """conll05.py:239-290 feature construction."""
        sent, verb, lbl = self._samples[idx]
        n = len(sent)
        try:
            vi = sent.index(verb)
        except ValueError:
            vi = next(i for i, l in enumerate(lbl) if l.startswith("B-V")) \
                if any(l.startswith("B-V") for l in lbl) else 0
        mark = [0] * n
        ctx = []
        for off in (-2, -1, 0, 1, 2):
            j = vi + off
            if 0 <= j < n:
                ctx.append(sent[j])
                mark[j] = 1
            else:
                ctx.append("bos" if j < 0 else "eos")
        unk = self.word_dict.get("<unk>", 0)
        word_idx = [self.word_dict.get(w, unk) for w in sent]
        ctx_idx = [[self.word_dict.get(c, unk)] * n for c in ctx]
        pred_idx = [self.predicate_dict[verb]] * n
        label_idx = [self.label_dict[l] for l in lbl]
        return (np.array(word_idx), np.array(ctx_idx[0]),
                np.array(ctx_idx[1]), np.array(ctx_idx[2]),
                np.array(ctx_idx[3]), np.array(ctx_idx[4]),
                np.array(pred_idx), np.array(mark), np.array(label_idx))

    def __len__(self):
        return len(self._samples)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict


class FakeTextDataset(Dataset):
    """Synthetic token-sequence dataset for LM tests/benchmarks."""

    def __init__(self, num_samples=256, seq_len=128, vocab_size=1000,
                 num_classes: Optional[int] = None, seed=0):
        self.num_samples = num_samples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        self._seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self._seed * 999_983 + idx)
        ids = rng.integers(0, self.vocab_size,
                           size=(self.seq_len,)).astype(np.int64)
        if self.num_classes is not None:
            return ids, np.int64(rng.integers(0, self.num_classes))
        return ids

    def __len__(self):
        return self.num_samples
