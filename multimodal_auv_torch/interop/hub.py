"""HuggingFace Hub weight retrieval, gated for offline machines (port of
``multimodal_auv_tpu/interop/hub.py``).

The reference downloads ``sams-tom/multimodal-auv-bathy-bnn-classifier`` /
``multimodal-bnn/pytorch_model.bin`` (its functions.py:43-64).
``huggingface_hub`` is imported only inside ``fetch_pretrained_weights``:
where it is not installed, the function returns None with a warning, as it
does offline, and the caller passes a local path instead.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

DEFAULT_REPO_ID = "sams-tom/multimodal-auv-bathy-bnn-classifier"
DEFAULT_SUBFOLDER = "multimodal-bnn"
DEFAULT_FILENAME = f"{DEFAULT_SUBFOLDER}/pytorch_model.bin"


def fetch_pretrained_weights(
    repo_id: str = DEFAULT_REPO_ID,
    filename: str = DEFAULT_FILENAME,
    local_path: Optional[str] = None,
) -> Optional[str]:
    """A local path to the pretrained checkpoint.

    An explicit ``local_path`` is authoritative: it is returned if it
    exists and raises FileNotFoundError otherwise (after a typo'd path,
    silently serving the hub's weights would attribute a survey's results
    to the wrong model). Without one, a cached or hub download is tried;
    offline and uncached, or without ``huggingface_hub``, it returns None
    with a warning, and the caller decides whether a random init will do."""
    if local_path:
        if os.path.exists(local_path):
            return local_path
        raise FileNotFoundError(
            f"model weights path {local_path!r} does not exist (omit it to "
            "use the HuggingFace Hub checkpoint)")

    try:
        from huggingface_hub import hf_hub_download

        if not _env_offline() and not _hub_reachable():
            # without this fast fail, huggingface_hub's connect-and-retry
            # backoff stalls for tens of seconds; a cached download may
            # still exist, so look there only
            logger.warning("HuggingFace Hub unreachable; checking the local "
                           "cache only (pass a local weights path to skip).")
            return hf_hub_download(repo_id=repo_id, filename=filename,
                                   local_files_only=True)
        return hf_hub_download(repo_id=repo_id, filename=filename)
    except Exception as e:
        logger.warning(
            "Could not fetch pretrained weights from the HuggingFace Hub "
            "(%s). Offline environment? Pass a local weights path.", e)
        return None


def _env_offline() -> bool:
    """HF_HUB_OFFLINE as huggingface_hub parses it: '0', 'false', 'no' and
    '' mean online."""
    return os.environ.get("HF_HUB_OFFLINE", "").upper() in (
        "1", "ON", "YES", "TRUE")


def _hub_reachable(timeout: float = 3.0) -> bool:
    """A TCP connect to the Hub's endpoint (no request is sent), or to the
    HTTP(S) proxy where one is set, since the download goes through it."""
    import socket
    from urllib.parse import urlparse

    endpoint = os.environ.get("HF_ENDPOINT", "https://huggingface.co")
    parsed = urlparse(endpoint)
    proxy = (os.environ.get("HTTPS_PROXY") or os.environ.get("https_proxy")
             if parsed.scheme == "https" else None) or \
        os.environ.get("HTTP_PROXY") or os.environ.get("http_proxy") or \
        os.environ.get("ALL_PROXY") or os.environ.get("all_proxy")
    if proxy:
        parsed = urlparse(proxy if "//" in proxy else "http://" + proxy)
    port = parsed.port or (80 if parsed.scheme == "http" else 443)
    try:
        socket.create_connection((parsed.hostname, port), timeout=timeout).close()
        return True
    except OSError:
        return False


def export_for_hub(bundle, out_dir: str,
                   subfolder: str = DEFAULT_SUBFOLDER) -> str:
    """Write a bundle in the repo layout the reference downloads
    (``{subfolder}/pytorch_model.bin``), ready for
    ``huggingface_hub.upload_folder``; returns the checkpoint's path."""
    from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint

    target = os.path.join(out_dir, subfolder)
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, "pytorch_model.bin")
    save_torch_checkpoint(bundle, path)
    return path
