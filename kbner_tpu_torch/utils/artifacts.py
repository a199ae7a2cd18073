"""Cached artifact resolution (counterpart of
``kbner_tpu/utils/artifacts.py``; the reference's ``flair/file_utils.py``).

``cached_path`` returns a local path as it is (it must exist) and
resolves a URL into a content-addressed cache directory. A URL not in the
cache is downloaded only when ``KBNER_ALLOW_DOWNLOAD=1``; otherwise it
raises, naming the cache file to place there. Archives (.zip, .tar.gz,
.tgz, .tar) unpack next to themselves (``extract_archive``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import zipfile
from pathlib import Path
from typing import Optional

DEFAULT_CACHE = Path(
    os.environ.get("KBNER_CACHE_DIR", "~/.cache/kbner_tpu")).expanduser()


def _is_url(s: str) -> bool:
    return s.startswith(("http://", "https://", "ftp://"))


def url_to_filename(url: str) -> str:
    """Content-addressed cache name: sha256(url) + original suffix (kept
    so archive detection works on the cached file)."""
    h = hashlib.sha256(url.encode("utf-8")).hexdigest()
    name = url.rsplit("/", 1)[-1]
    suffix = ""
    for ext in (".tar.gz", ".tgz", ".zip", ".gz", ".bz2", ".npz", ".txt",
                ".vec", ".bin", ".json", ".msgpack"):
        if name.endswith(ext):
            suffix = ext
            break
    return h + suffix


def cached_path(
    url_or_path: str | Path,
    cache_dir: Optional[str | Path] = None,
    extract: bool = False,
) -> Path:
    """Resolve an artifact reference to a local file path.

    - local path: returned unchanged (must exist),
    - URL already in cache: the cached file (or extraction dir),
    - URL not cached: downloaded only when ``KBNER_ALLOW_DOWNLOAD=1``;
      otherwise raises with the exact cache path to pre-seed.
    """
    s = str(url_or_path)
    if not _is_url(s):
        p = Path(s).expanduser()
        if not p.exists():
            raise FileNotFoundError(f"artifact not found: {p}")
        return p

    cache = Path(cache_dir) if cache_dir else DEFAULT_CACHE
    cache.mkdir(parents=True, exist_ok=True)
    target = cache / url_to_filename(s)
    if not target.exists():
        if os.environ.get("KBNER_ALLOW_DOWNLOAD") != "1":
            raise FileNotFoundError(
                f"{s} is not cached and downloads are disabled "
                f"(zero-egress default). Pre-seed the file at {target} "
                "or set KBNER_ALLOW_DOWNLOAD=1.")
        from urllib.request import urlopen

        tmp = target.with_suffix(target.suffix + ".part")
        with urlopen(s) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        tmp.rename(target)
    if extract:
        return extract_archive(target)
    return target


def extract_archive(path: Path) -> Path:
    """Unpack a .zip/.tar.gz/.tgz next to itself (idempotent); returns
    the extraction directory (flair's unzip_file,
    file_utils.py:230-267)."""
    out = path.parent / (path.name + ".extracted")
    if out.exists():
        return out
    tmp = path.parent / (path.name + ".extracting")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    name = path.name
    if name.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
    elif name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(path) as t:
            t.extractall(tmp, filter="data")
    else:
        shutil.rmtree(tmp)
        raise ValueError(f"not a recognized archive: {path}")
    tmp.rename(out)
    return out
