"""Media acquisition: hub snapshot -> zip/tar extraction -> task cache dir,
plus the YouTube-download sentinel protocol.

Counterpart of the reference's task-init download machinery
(lmms_eval/api/task.py:876-1010): snapshot-download the dataset repo,
recursively discover ``**/*.zip`` and ``**/*.tar*`` blobs, extract them
into ``$HF_HOME/<cache_dir>`` skipping already-extracted members, and
concatenate multi-part tars (``x.tar.part0, x.tar.part1, ...``) before
extraction. Task modules then resolve video paths under that cache dir
(e.g. lmms_eval/tasks/vdc/utils.py:39-47).

Design differences from the reference (deliberate):
  - Everything is behind an explicit ``allow_download`` flag
    (``videoitg-eval --allow_download``); the default is local-first and
    never touches the network. The reference downloads implicitly at task
    init.
  - The YouTube status sentinel is written next to the downloaded videos,
    not into the read-only hub snapshot cache the reference mutates
    (api/task.py:884-890 writes ``{task}_download_status.json`` into
    ``snapshot_download(...)``'s return dir).
  - ``yt-dlp`` is invoked with an argv list, not ``shell=True``
    (api/task.py:883 interpolates the video id into a shell string).
  - Acquisition is idempotent and testable offline: ``snapshot_dir`` can
    point at any local directory laid out like a hub snapshot, and the
    YouTube downloader is injectable.

Note: every ``From_YouTube`` occurrence in the reference's video-task
yamls is commented out (e.g. tasks/videomme/videomme.yaml:5,
tasks/vatex/vatex_test.yaml:33) — the protocol is dormant machinery in
the reference too; it is implemented here for parity of capability.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import tarfile
import zipfile
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple


class MediaUnavailableError(RuntimeError):
    """Media is not on disk and downloading was not authorized."""


@dataclass(frozen=True)
class MediaSpec:
    """Where a task's video blobs live on the hub and in the local cache.

    Mirrors the reference's ``dataset_kwargs`` (``dataset_path`` +
    ``cache_dir`` + ``video: True`` + the optional ``From_YouTube``
    sentinel, e.g. tasks/videomme/videomme.yaml:1-6).
    """

    repo_id: str            # HF dataset repo (reference dataset_path)
    cache_dir: str          # directory under media_home() (dataset_kwargs.cache_dir)
    revision: str = "main"
    subdir: Optional[str] = None  # videos live under cache_dir/subdir
                                  # (vdc joins "Test_Videos", vdc/utils.py:47)
    from_youtube: bool = False
    youtube_id_key: str = "videoID"  # doc field holding the YouTube id
                                     # (api/task.py:880)
    # Image benchmarks ship their visuals INSIDE the dataset rows (the
    # reference's HF splits embed PIL objects, e.g. mme/utils.py:37-38) —
    # there are no blob archives to extract, so acquisition is just the
    # docs loader (datasets.load_dataset). The spec still records the hub
    # repo id for auditability.
    embedded: bool = False


def media_home() -> str:
    """Root under which task caches are extracted.

    ``$VIDEOITG_MEDIA_HOME`` wins; else the reference's convention
    ``$HF_HOME`` (api/task.py:934), else ``~/.cache/huggingface``.
    """
    home = os.environ.get("VIDEOITG_MEDIA_HOME") or os.environ.get(
        "HF_HOME", "~/.cache/huggingface/")
    return os.path.expanduser(home)


def _cache_populated(cache_dir: str) -> bool:
    if not os.path.isdir(cache_dir):
        return False
    for _root, _dirs, files in os.walk(cache_dir):
        if files:
            return True
    return False


def acquire_media(spec: MediaSpec, *, allow_download: bool = False,
                  snapshot_dir: Optional[str] = None,
                  force_unzip: bool = False) -> str:
    """Ensure ``spec``'s videos are extracted locally; return the video dir.

    Resolution order:
      1. cache already populated (and not ``force_unzip``) -> reuse, no IO;
      2. ``snapshot_dir`` given -> extract its archives (offline path);
      3. ``allow_download`` -> ``huggingface_hub.snapshot_download`` the
         dataset repo, then extract (reference api/task.py:944-1005);
      4. otherwise raise ``MediaUnavailableError`` with instructions.
    """
    if spec.embedded:
        raise ValueError(
            f"{spec.repo_id} embeds its visuals in the dataset rows; "
            "there is no media archive to acquire — load the docs instead")
    cache_dir = os.path.join(media_home(), spec.cache_dir)
    video_dir = (os.path.join(cache_dir, spec.subdir)
                 if spec.subdir else cache_dir)
    if _cache_populated(cache_dir) and not force_unzip:
        return video_dir
    if snapshot_dir is None:
        if not allow_download:
            raise MediaUnavailableError(
                f"media for {spec.repo_id} not found under {cache_dir}; "
                f"pass --allow_download to fetch it from the hub, or place "
                f"the extracted videos there (or point --data_root at them)")
        from huggingface_hub import snapshot_download

        snapshot_dir = snapshot_download(
            repo_id=spec.repo_id, repo_type="dataset",
            revision=spec.revision, etag_timeout=60)
    extract_archives(snapshot_dir, cache_dir, overwrite=force_unzip)
    return video_dir


def extract_archives(snapshot_dir: str, cache_dir: str,
                     overwrite: bool = False) -> List[str]:
    """Extract every zip / (multi-part) tar under ``snapshot_dir``.

    Zip members already present in ``cache_dir`` are skipped (the
    reference's resume-after-partial-unzip behavior, api/task.py:948-957)
    unless ``overwrite`` — the --force_unzip path, which re-extracts
    everything so a truncated file from an interrupted run is repaired.
    Tar parts sharing a basename before ``.tar`` are concatenated in
    sorted order into one stream first (api/task.py:969-976).
    Returns the list of archives processed.
    """
    os.makedirs(cache_dir, exist_ok=True)
    processed: List[str] = []
    for zip_file in sorted(glob.glob(os.path.join(snapshot_dir, "**", "*.zip"),
                                     recursive=True)):
        with zipfile.ZipFile(zip_file) as zf:
            for info in zf.infolist():
                target = os.path.join(cache_dir, info.filename)
                if not _is_within(cache_dir, target):  # zip-slip guard
                    raise RuntimeError(
                        f"unsafe member path {info.filename!r} in {zip_file}")
                if overwrite or not os.path.exists(target):
                    zf.extract(info, cache_dir)
        processed.append(zip_file)

    tar_groups: dict = {}
    # ".tgz" carries no ".tar" substring, so it needs its own glob.
    tar_paths = (glob.glob(os.path.join(snapshot_dir, "**", "*.tar*"),
                           recursive=True)
                 + glob.glob(os.path.join(snapshot_dir, "**", "*.tgz"),
                             recursive=True))
    for tar_file in sorted(tar_paths):
        base = (tar_file[: -len(".tgz")] if tar_file.endswith(".tgz")
                else tar_file.split(".tar")[0])
        tar_groups.setdefault(base, []).append(tar_file)
    for base, parts in sorted(tar_groups.items()):
        if len(parts) == 1 and parts[0].endswith((".tar", ".tar.gz", ".tgz")):
            stream = parts[0]
            cleanup = None
        else:
            # split archive: concatenate parts in sorted order
            stream = base + ".tar.joined"
            with open(stream, "wb") as out:
                for part in sorted(parts):
                    with open(part, "rb") as pf:
                        shutil.copyfileobj(pf, out)
            cleanup = stream
        try:
            with tarfile.open(stream) as tf:
                for member in tf.getmembers():
                    target = os.path.join(cache_dir, member.name)
                    if not _is_within(cache_dir, target):
                        raise RuntimeError(
                            f"unsafe member path {member.name!r} in {base}")
                    if overwrite or not os.path.exists(target):
                        tf.extract(member, cache_dir)
        finally:
            if cleanup and os.path.exists(cleanup):
                os.remove(cleanup)
        processed.extend(parts)
    return processed


def _is_within(root: str, path: str) -> bool:
    root = os.path.abspath(root)
    return os.path.commonpath(
        [root, os.path.abspath(path)]) == root


def _ytdlp_download(video_id: str, target_path: str) -> bool:
    """Default downloader: yt-dlp as an argv subprocess (no shell)."""
    exe = shutil.which("yt-dlp")
    if exe is None:
        raise MediaUnavailableError(
            "yt-dlp must be installed and on PATH for From_YouTube tasks")
    r = subprocess.run(
        [exe, "-o", target_path, "-f", "mp4",
         f"https://www.youtube.com/watch?v={video_id}"],
        capture_output=True, text=True)
    return r.returncode == 0 and os.path.exists(target_path)


def acquire_youtube(spec: MediaSpec, docs: Sequence[dict], *,
                    allow_download: bool = False,
                    downloader: Optional[Callable[[str, str], bool]] = None,
                    ) -> Tuple[str, List[dict]]:
    """YouTube sentinel protocol; returns (video_dir, docs-with-video).

    Mirrors api/task.py:876-931: download each doc's ``videoID`` as
    ``<id>.mp4`` into the task's media dir, record a
    ``<cache_dir>_download_status.json`` sentinel so reruns skip the
    sweep, and filter the doc list to ids whose video actually landed
    (failed downloads shrink the eval set rather than crashing it).
    """
    video_dir = os.path.join(media_home(), spec.cache_dir)
    os.makedirs(video_dir, exist_ok=True)
    sentinel = os.path.join(
        video_dir, f"{os.path.basename(spec.cache_dir)}_download_status.json")
    status = None
    if os.path.exists(sentinel):
        with open(sentinel) as f:
            status = json.load(f).get(spec.cache_dir)
    if status != "downloaded" and allow_download:
        downloader = downloader or _ytdlp_download
        ok = True
        for doc in docs:
            vid = str(doc[spec.youtube_id_key])
            target = os.path.join(video_dir, f"{vid}.mp4")
            if os.path.exists(target):
                continue
            try:
                if not downloader(vid, target):
                    ok = False
            except MediaUnavailableError:
                raise
            except Exception:
                ok = False
        with open(sentinel, "w") as f:
            json.dump({spec.cache_dir:
                       "downloaded" if ok else "not downloaded"}, f)
    have = {os.path.splitext(name)[0] for name in os.listdir(video_dir)
            if name.endswith(".mp4")}
    kept = [d for d in docs if str(d.get(spec.youtube_id_key)) in have]
    if not kept and not allow_download:
        raise MediaUnavailableError(
            f"no downloaded videos under {video_dir} for a From_YouTube "
            f"task; pass --allow_download (requires yt-dlp) or stage "
            f"<videoID>.mp4 files there")
    return video_dir, kept


def resolve_task_media(task, data_root: str, *, allow_download: bool = False,
                       force_unzip: bool = False) -> str:
    """Effective data_root for a task: explicit --data_root wins; else the
    task's MediaSpec cache (acquiring it if authorized); else ''."""
    if data_root:
        return data_root
    spec = getattr(task, "media", None)
    if spec is None or spec.from_youtube or spec.embedded:
        return data_root
    try:
        return acquire_media(spec, allow_download=allow_download,
                             force_unzip=force_unzip)
    except MediaUnavailableError:
        if allow_download:
            raise
        # Local-first default: keep the historical behavior (tasks fall
        # back to relative paths / hub docs) when downloads are off.
        return data_root
