"""Path helpers, API-compatible with utils/path_utils.py:2-41 (posix/windows safe)."""

from __future__ import annotations


def get_filename(file_path: str, is_suffix: bool = True) -> str:
    name = file_path.replace("\\", "/").rsplit("/", 1)[-1]
    if is_suffix:
        return name
    idx = name.rfind(".")
    return name[:idx] if idx > 0 else name


def get_parent_folder(file_path: str, with_root: bool = False) -> str:
    path = file_path.replace("\\", "/")
    idx = path.rfind("/")
    parent = path[:idx]
    if not with_root:
        return get_filename(parent)
    return parent


def split_filename(file_path: str, split_str: str):
    idx = file_path.index(split_str)
    return file_path[:idx], file_path[idx:]
