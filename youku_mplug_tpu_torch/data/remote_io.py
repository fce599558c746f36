"""Counterpart of ``youku_mplug_tpu/data/remote_io.py``: the same fetch,
retry, cache and eviction, ``oss2`` imported lazily as there.  The
cache defaults to ``youku_mplug_tpu_torch_remote`` under the temporary
directory (``YOUKU_MPLUG_CACHE`` overrides its parent), and the port
decodes a spooled file through cv2 (``data/video_decode.py``).

Remote object-store IO for video datasets (oss:// and http(s)://).

The reference reads training videos straight from Alibaba OSS buckets
(reference: dataset/video_pretrain_dataset.py:34-37 bucket construction
from OSS_INFO credentials, :70-82 get_object with retry; video_utils/
utils.py:138 tar-from-bucket).  Here, with a different shape: instead of handing a BytesIO to a python decoder, we
spool the object to a local cache file (atomic rename, shared across
DataLoader workers) because the decoder wants a seekable file.

Dependency-gated: ``oss2`` is imported only when an oss:// URI is first
fetched; absent the SDK, a clear ImportError tells the user what to
install.  http(s):// uses stdlib urllib.  Credentials come from an
``OSS_INFO``-style dict (same schema as the reference: ``{bucket:
{"AK", "SK", "ENDPOINT"}}``) via :func:`configure_oss`, or from the
``OSS_ACCESS_KEY_ID`` / ``OSS_ACCESS_KEY_SECRET`` / ``OSS_ENDPOINT``
environment variables.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
import urllib.parse
import urllib.request
from typing import Dict, Optional

_OSS_INFO: Dict[str, dict] = {}
_BUCKETS: Dict[str, object] = {}

DEFAULT_CACHE = os.path.join(
    os.environ.get("YOUKU_MPLUG_CACHE", tempfile.gettempdir()),
    "youku_mplug_tpu_torch_remote")

REMOTE_SCHEMES = ("oss://", "http://", "https://")


def is_remote(path: str) -> bool:
    return isinstance(path, str) and path.startswith(REMOTE_SCHEMES)


def configure_oss(oss_info: Dict[str, dict]) -> None:
    """Register per-bucket credentials, reference OSS_INFO schema:
    ``{bucket_name: {"AK": ..., "SK": ..., "ENDPOINT": ...}}``."""
    _OSS_INFO.update(oss_info)
    _BUCKETS.clear()


def _bucket(bucket_name: str):
    if bucket_name in _BUCKETS:
        return _BUCKETS[bucket_name]
    try:
        import oss2  # optional vendor SDK, never a hard dependency
    except ImportError as e:  # pragma: no cover - exercised via fake in CI
        raise ImportError(
            "oss:// paths need the oss2 SDK (pip install oss2); "
            "alternatively pre-download the corpus and use local paths"
        ) from e
    info = _OSS_INFO.get(bucket_name)
    if info is None:
        ak = os.environ.get("OSS_ACCESS_KEY_ID")
        sk = os.environ.get("OSS_ACCESS_KEY_SECRET")
        endpoint = os.environ.get("OSS_ENDPOINT")
        if not (ak and sk and endpoint):
            raise KeyError(
                f"no credentials for bucket '{bucket_name}': call "
                "configure_oss({bucket: {'AK','SK','ENDPOINT'}}) or set "
                "OSS_ACCESS_KEY_ID/OSS_ACCESS_KEY_SECRET/OSS_ENDPOINT")
        info = {"AK": ak, "SK": sk, "ENDPOINT": endpoint}
    auth = oss2.Auth(info["AK"], info["SK"])
    b = oss2.Bucket(auth, info["ENDPOINT"], bucket_name)
    _BUCKETS[bucket_name] = b
    return b


def read_bytes(uri: str, retries: int = 3, backoff: float = 0.5) -> bytes:
    """Fetch a remote object fully into memory, with retry (the
    reference's 3-try loop, video_pretrain_dataset.py:70-82)."""
    err: Optional[Exception] = None
    for attempt in range(retries):
        try:
            if uri.startswith("oss://"):
                parsed = urllib.parse.urlparse(uri)
                return _bucket(parsed.netloc).get_object(
                    parsed.path.lstrip("/")).read()
            if uri.startswith(("http://", "https://")):
                with urllib.request.urlopen(uri, timeout=60) as r:
                    return r.read()
            with open(uri, "rb") as f:  # local fallthrough
                return f.read()
        except (ImportError, KeyError):
            raise  # configuration errors never resolve by retrying
        except Exception as e:  # noqa: BLE001 - network/IO flake
            err = e
            time.sleep(backoff * (2 ** attempt))
    raise IOError(f"failed to fetch {uri} after {retries} tries: {err}")


def fetch(uri: str, cache_dir: Optional[str] = None, retries: int = 3
          ) -> str:
    """Remote URI -> local file path (cached, atomic, worker-safe).

    ``cache_dir`` defaults to the module-level DEFAULT_CACHE (resolved at
    call time so tests/operators can repoint it).

    Local paths pass through untouched.  The cache key hashes the full
    URI; concurrent workers racing on the same object each write a temp
    file and os.replace it — last writer wins with identical bytes (the
    same discipline as the tar extraction in video_decode.py)."""
    if not is_remote(uri):
        return uri
    cache_dir = cache_dir or DEFAULT_CACHE
    name = hashlib.sha256(uri.encode()).hexdigest()[:24]
    ext = os.path.splitext(urllib.parse.urlparse(uri).path)[1][:8]
    out = os.path.join(cache_dir, name + ext)
    if os.path.exists(out):
        return out
    data = read_bytes(uri, retries=retries)
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, out)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out


def evict(uri: str, cache_dir: Optional[str] = None) -> None:
    """Drop a cached object (e.g. after a corrupt-file decode failure so
    the retry loop re-downloads rather than re-reading the bad spool)."""
    if not is_remote(uri):
        return
    cache_dir = cache_dir or DEFAULT_CACHE
    name = hashlib.sha256(uri.encode()).hexdigest()[:24]
    ext = os.path.splitext(urllib.parse.urlparse(uri).path)[1][:8]
    out = os.path.join(cache_dir, name + ext)
    if os.path.exists(out):
        os.unlink(out)
