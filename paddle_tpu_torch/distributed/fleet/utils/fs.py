"""Filesystem abstraction — LocalFS + HDFSClient (port of
paddle_tpu/distributed/fleet/utils/fs.py).

Reference: python/paddle/distributed/fleet/utils/fs.py (FS base, LocalFS,
HDFSClient shelling to ``hadoop fs``) + paddle/fluid/framework/io/fs.cc.
Checkpoint/dataset code talks to this interface so the same training
script runs against local disk or an HDFS-compatible store.  HDFSClient
drives the ``hadoop`` CLI exactly like the reference; constructing it
without the binary raises immediately with a clear message.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

__all__ = ["ExecuteError", "FSFileExistsError", "FSFileNotExistsError",
           "FSTimeOut", "FSShellCmdAborted", "FS", "LocalFS", "HDFSClient",
           "fsync_dir"]


def fsync_dir(dirpath: str):
    """fsync a DIRECTORY: tmp+rename alone is not crash-durable on ext4 —
    the rename lives in the directory inode, and a power cut can forget
    it even though the file's own bytes were fsynced.  Every crash-safe
    writer in the tree (LocalFS.atomic_write, checkpoint shard writes,
    the elastic FileStore) commits through this after its rename.
    Best-effort on filesystems that refuse directory fsync (EINVAL on
    some network mounts): the rename is still atomic, just not durable
    past a power cut there."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    """Interface (reference fs.py:57)."""

    def ls_dir(self, fs_path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_file(self, fs_path) -> bool:
        raise NotImplementedError

    def is_dir(self, fs_path) -> bool:
        raise NotImplementedError

    def is_exist(self, fs_path) -> bool:
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self) -> bool:
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path) -> List[str]:
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path) -> str:
        raise NotImplementedError

    def atomic_write(self, fs_path, data):
        raise NotImplementedError


class LocalFS(FS):
    """Local-disk implementation (reference fs.py:115)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        assert not os.path.isfile(fs_path), f"{fs_path} is already a file"
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if os.path.isfile(fs_path):
            os.remove(fs_path)
        elif os.path.isdir(fs_path):
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if os.path.exists(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        if self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return sorted(
            n for n in os.listdir(fs_path)
            if os.path.isdir(os.path.join(fs_path, n)))

    def upload(self, local_path, fs_path):
        # local<->local copy keeps checkpoint code path-agnostic
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy2(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def cat(self, fs_path):
        with open(fs_path) as f:
            return f.read()

    def atomic_write(self, fs_path, data):
        """Crash-safe write: tmp file + fsync + os.replace + parent-dir
        fsync, so a kill at any instant leaves either the old file or
        the new one — never a torn mix — and the rename itself survives
        a power cut (tmp+rename alone is not crash-durable on ext4: the
        rename lives in the directory inode, which needs its own fsync).
        The ``fs.write`` chaos point sits in the torn-write window
        (after the tmp write, before the rename) so the fault-injection
        suite can prove exactly that property."""
        from paddle_tpu_torch.framework import chaos
        mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
        tmp = f"{fs_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, mode) as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            chaos.fault_point("fs.write", meta={"path": fs_path})
            os.replace(tmp, fs_path)           # atomic commit point
            fsync_dir(os.path.dirname(fs_path))
        except BaseException:
            # a simulated crash leaves the destination untouched; drop
            # the orphan tmp so transient errors don't accumulate litter
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise


class HDFSClient(FS):
    """``hadoop fs`` CLI driver (reference fs.py:419).

    ``hadoop_home``: install prefix holding bin/hadoop; ``configs``: dict
    of -D overrides (e.g. fs.default.name, hadoop.job.ugi).
    """

    def __init__(self, hadoop_home: str, configs: Optional[dict] = None,
                 time_out: int = 5 * 60 * 1000, sleep_inter: int = 1000):
        self._base = os.path.join(hadoop_home, "bin", "hadoop")
        if not os.path.exists(self._base):
            raise ExecuteError(
                f"hadoop binary not found at {self._base} — HDFSClient "
                "needs a hadoop install (same requirement as the "
                "reference's shell-driven client)")
        self._cfg = []
        for k, v in (configs or {}).items():
            self._cfg += ["-D", f"{k}={v}"]
        self._timeout_s = time_out / 1000.0

    def _run(self, *args, check=True) -> Tuple[int, str]:
        cmd = [self._base, "fs"] + self._cfg + list(args)
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self._timeout_s)
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(" ".join(cmd)) from e
        if check and p.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)}: {p.stderr.strip()}")
        return p.returncode, p.stdout

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        _, out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def is_exist(self, fs_path):
        rc, _ = self._run("-test", "-e", fs_path, check=False)
        return rc == 0

    def is_dir(self, fs_path):
        rc, _ = self._run("-test", "-d", fs_path, check=False)
        return rc == 0

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run("-rm", "-r", "-f", fs_path)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def need_upload_download(self):
        return True

    def rename(self, fs_src_path, fs_dst_path):
        self._run("-mv", fs_src_path, fs_dst_path)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        if test_exists:
            if not self.is_exist(fs_src_path):
                raise FSFileNotExistsError(fs_src_path)
            if not overwrite and self.is_exist(fs_dst_path):
                raise FSFileExistsError(fs_dst_path)
        if overwrite and self.is_exist(fs_dst_path):
            self.delete(fs_dst_path)
        self._run("-mv", fs_src_path, fs_dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        self._run("-touchz", fs_path)

    def cat(self, fs_path):
        _, out = self._run("-cat", fs_path)
        return out

    def atomic_write(self, fs_path, data):
        """Crash-safe write over the ``hadoop fs`` shell.  The shell has
        no atomic overwrite-rename, so this is commit-with-backup rather
        than LocalFS's single rename: upload to tmp, move any existing
        file aside, ``-mv`` the tmp into place, drop the backup.  A crash
        at any instant leaves the old content recoverable — at
        ``fs_path`` or ``fs_path.old`` — never lost, and never a torn
        file under the final name."""
        import tempfile

        from paddle_tpu_torch.framework import chaos
        mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
        with tempfile.NamedTemporaryFile(mode, delete=False) as f:
            f.write(data)
            # same durability fix as LocalFS: the staged bytes must be on
            # disk before the shell upload reads them back
            f.flush()
            os.fsync(f.fileno())
            local = f.name
        remote_tmp = f"{fs_path}.tmp.{os.getpid()}"
        backup = f"{fs_path}.old"
        try:
            self._run("-put", "-f", local, remote_tmp)
            chaos.fault_point("fs.write", meta={"path": fs_path})
            had_old = self.is_exist(fs_path)
            if had_old:
                self.delete(backup)
                self._run("-mv", fs_path, backup)
            try:
                self._run("-mv", remote_tmp, fs_path)
            except ExecuteError:
                if had_old:                     # put the old file back
                    self._run("-mv", backup, fs_path)
                raise
            if had_old:
                self.delete(backup)
        except BaseException:
            try:
                self.delete(remote_tmp)         # no tmp litter on failure
            except ExecuteError:
                pass
            raise
        finally:
            os.remove(local)
