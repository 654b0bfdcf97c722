"""Download and extraction helpers (counterpart of
`gammagl_tpu/data/download.py`; reference: gammagl/data/{download,
extract}.py).

The switch is the JAX package's: ``GGL_TPU_OFFLINE=1`` refuses every
download before the network is touched, and `network_available` then
answers False at once. Tests stage raw files or use synthetic datasets.
"""

import gzip
import os
import os.path as osp
import shutil
import socket
import ssl
import sys
import tarfile
import threading
import urllib.request
import zipfile

# tarfile's "data" filter where this Python has it (3.12 and later)
_SAFE = ({"filter": "data"} if hasattr(tarfile, "data_filter") else {})

__all__ = ["download_url", "extract_zip", "extract_tar", "extract_gz",
           "offline", "network_available"]


def offline() -> bool:
    """True when downloads are disabled (``GGL_TPU_OFFLINE`` set to
    anything but "" or "0")."""
    return os.environ.get("GGL_TPU_OFFLINE", "0") not in ("", "0")


def network_available(host: str = "github.com", timeout: float = 3.0):
    """Best-effort connectivity probe: False at once when `offline()`,
    else a DNS lookup of ``host`` in a daemon thread with a deadline of
    ``timeout`` seconds (a resolver that hangs costs that once)."""
    if offline():
        return False
    result = []

    def probe():
        try:
            result.append(socket.gethostbyname(host))
        except OSError:
            pass

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout)
    return bool(result)


def download_url(url: str, folder: str, log: bool = True, filename=None,
                 timeout: float = 15.0):
    """Fetch ``url`` into ``folder`` unless the file is there already;
    returns its path. Raises OSError when `offline()`."""
    filename = filename or url.rpartition("/")[2].split("?")[0]
    path = osp.join(folder, filename)
    if osp.exists(path):
        return path
    if offline():
        raise OSError(f"GGL_TPU_OFFLINE=1: refusing to download {url}")
    os.makedirs(folder, exist_ok=True)
    if log:
        print(f"Downloading {url}", file=sys.stderr)
    ctx = ssl._create_unverified_context()
    data = urllib.request.urlopen(url, context=ctx, timeout=timeout)
    with open(path, "wb") as f:
        while True:
            chunk = data.read(10 * 1024 * 1024)
            if not chunk:
                break
            f.write(chunk)
    return path


def extract_zip(path, folder):
    with zipfile.ZipFile(path, "r") as f:
        f.extractall(folder)


def extract_tar(path, folder, mode="r:gz"):
    """Unpack a tar archive; members that would land outside ``folder``
    (absolute paths, links out) are refused (tarfile's "data" filter)."""
    with tarfile.open(path, mode) as f:
        f.extractall(folder, **_SAFE)


def extract_gz(path, folder):
    """Decompress ``path`` into ``folder`` (its name without ".gz");
    returns the new file's path."""
    out = osp.join(folder, osp.basename(path).replace(".gz", ""))
    with gzip.open(path, "rb") as fin, open(out, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    return out
