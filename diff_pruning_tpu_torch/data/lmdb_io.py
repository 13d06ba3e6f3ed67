"""Pure-Python LMDB access (counterpart of ``diff_pruning_tpu/data/lmdb_io.py``):
no ``lmdb`` library is needed.

LSUN and FFHQ come as lmdb databases (read with py-lmdb by the DDIM
codebase). This module implements the on-disk format directly: a read-only
B+tree walk (:class:`LMDBReader`) and a minimal writer (:func:`write_lmdb`)
that builds LSUN-layout databases from image folders and test fixtures.

Format notes (lmdb/libraries/liblmdb/mdb.c, 64-bit layout):
* 16-byte page header: pgno u64, pad u16, flags u16, lower u16, upper u16
  (for overflow pages the last 4 bytes are pb_pages u32);
* meta pages 0/1: header + MDB_meta {magic 0xBEEFC0DE, version 1, address,
  mapsize, MDB_db[2], last_pg, txnid}; MDB_db is 48 bytes and the page size
  lives in mm_dbs[0].md_pad; the live meta is the one with the larger txnid;
* node: mn_lo u16, mn_hi u16, mn_flags u16, mn_ksize u16, key bytes, then
  value bytes (leaf) or nothing (branch). Leaf data size = lo | hi<<16;
  branch child pgno = lo | hi<<16 | flags<<32. F_BIGDATA (0x01) stores an
  8-byte overflow pgno instead of the value; the value then lives at
  overflow_page*psize + 16, contiguous across pb_pages pages.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01
PAGEHDRSZ = 16
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch/leaf/ovf pages, entries, root
_PAGEHDR = struct.Struct("<QHHHH")
_NODEHDR = struct.Struct("<HHHH")


class LMDBError(ValueError):
    pass


def _db_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LMDBReader:
    """Read-only access to an LMDB main database (what ``lmdb.open(...,
    readonly=True)`` gives the DDIM codebase's LSUN and FFHQ loaders)."""

    def __init__(self, path: str):
        self.path = _db_path(path)
        self._f = open(self.path, "rb")
        self._pick_meta()

    # -- low level ---------------------------------------------------------
    def _read(self, off: int, n: int) -> bytes:
        # pread: positioned read with no shared file offset, so one reader
        # is safe under the threaded decode pools (decode pools).
        buf = os.pread(self._f.fileno(), n, off)
        while 0 < len(buf) < n:  # pread may return short on some filesystems
            more = os.pread(self._f.fileno(), n - len(buf), off + len(buf))
            if not more:
                break
            buf += more
        return buf

    def _parse_meta(self, off_bytes: int):
        need = PAGEHDRSZ + _META.size + 2 * _DB.size + 16
        raw = self._read(off_bytes, need)
        if len(raw) < need:
            raise LMDBError(f"{self.path}: truncated meta page at {off_bytes}")
        magic, version, _addr, _mapsize = _META.unpack_from(raw, PAGEHDRSZ)
        if magic != MAGIC:
            raise LMDBError(f"{self.path}: bad LMDB magic {magic:#x}")
        if version != 1:
            raise LMDBError(f"unsupported LMDB data version {version}")
        off = PAGEHDRSZ + _META.size
        db0 = _DB.unpack_from(raw, off)
        db1 = _DB.unpack_from(raw, off + _DB.size)
        _last_pg, txnid = struct.unpack_from("<QQ", raw, off + 2 * _DB.size)
        return txnid, db0[0], db1

    def _pick_meta(self):
        # meta 0 at offset 0 tells us the page size; meta 1 sits at +psize
        m0 = self._parse_meta(0)
        metas = [m0, self._parse_meta(m0[1])]
        txnid, psize, main = max(metas, key=lambda m: m[0])
        if psize == 0 or psize & (psize - 1):
            raise LMDBError(f"implausible page size {psize}")
        self.psize = psize
        (self._pad, self._flags, self.depth, _b, _l, _o,
         self.entries, self.root) = main

    def _page(self, pgno: int) -> bytes:
        return self._read(pgno * self.psize, self.psize)

    @staticmethod
    def _page_hdr(raw: bytes) -> Tuple[int, int, int, int]:
        pgno, _pad, flags, lower, upper = _PAGEHDR.unpack_from(raw, 0)
        return pgno, flags, lower, upper

    @staticmethod
    def _numkeys(lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, raw: bytes, i: int) -> Tuple[int, int, bytes, int]:
        """(flags, data_size_or_pgno_lohi, key, node_offset)."""
        (ptr,) = struct.unpack_from("<H", raw, PAGEHDRSZ + 2 * i)
        lo, hi, flags, ksize = _NODEHDR.unpack_from(raw, ptr)
        key = raw[ptr + 8:ptr + 8 + ksize]
        return flags, lo | (hi << 16), key, ptr

    def _leaf_value(self, raw: bytes, i: int) -> bytes:
        flags, dsize, key, ptr = self._node(raw, i)
        voff = ptr + 8 + len(key)
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", raw, voff)
            return self._read(ovpg * self.psize + PAGEHDRSZ, dsize)
        return raw[voff:voff + dsize]

    def _branch_child(self, raw: bytes, i: int) -> int:
        (ptr,) = struct.unpack_from("<H", raw, PAGEHDRSZ + 2 * i)
        lo, hi, flags, _ksize = _NODEHDR.unpack_from(raw, ptr)
        return lo | (hi << 16) | (flags << 32)

    # -- public ------------------------------------------------------------
    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order (key, value) cursor over the main DB."""
        for raw, i, key in self._leaf_nodes():
            yield key, self._leaf_value(raw, i)

    def keys(self) -> List[bytes]:
        """The main DB's keys in order (the LSUN loader's key scan): a walk
        of the leaf nodes that reads no value, overflow pages included."""
        return [key for _raw, _i, key in self._leaf_nodes()]

    def _leaf_nodes(self) -> Iterator[Tuple[bytes, int, bytes]]:
        """In-order (leaf page, node index, key) over the main DB."""
        if self.root == INVALID_PGNO:
            return
        stack = [self.root]
        # iterative DFS, leftmost-first: expand branches in reverse order
        while stack:
            raw = self._page(stack.pop())
            _pgno, flags, lower, _upper = self._page_hdr(raw)
            n = self._numkeys(lower)
            if flags & P_LEAF:
                for i in range(n):
                    yield raw, i, self._node(raw, i)[2]
            elif flags & P_BRANCH:
                stack.extend(self._branch_child(raw, i)
                             for i in range(n - 1, -1, -1))
            elif flags & P_LEAF2:
                raise LMDBError("MDB_DUPFIXED pages unsupported")
            else:
                raise LMDBError(f"unexpected page flags {flags:#x} in tree")

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup by memcmp order (txn.get equivalent)."""
        if self.root == INVALID_PGNO:
            return None
        pgno = self.root
        for _ in range(self.depth + 1):
            raw = self._page(pgno)
            _pg, flags, lower, _upper = self._page_hdr(raw)
            n = self._numkeys(lower)
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _f, _d, k, _p = self._node(raw, mid)
                    if k == key:
                        return self._leaf_value(raw, mid)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: rightmost child whose separator <= key (node 0's key
            # is empty = leftmost)
            child = self._branch_child(raw, 0)
            for i in range(1, n):
                _f, _d, k, _p = self._node(raw, i)
                if k <= key:
                    child = self._branch_child(raw, i)
                else:
                    break
            pgno = child
        raise LMDBError("tree deeper than recorded depth")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_lmdb(path: str, items: List[Tuple[bytes, bytes]],
               psize: int = 4096) -> str:
    """Minimal LMDB writer: meta pages + leaf pages + as many branch levels
    as the item count needs + overflow pages for big values. Enough to
    produce databases the C library and :class:`LMDBReader` both read; used
    for LSUN-layout conversion (hundreds of thousands of entries) and test
    fixtures."""
    items = sorted(items, key=lambda kv: kv[0])
    pages: List[bytes] = [b"", b""]  # metas filled last

    def node_bytes(lo, hi, flags, key, inline=b""):
        return _NODEHDR.pack(lo, hi, flags, len(key)) + key + inline

    def emit_page(flags: int, nodes: List[bytes], extra_hdr: bytes = b"") -> int:
        n = len(nodes)
        lower = PAGEHDRSZ + 2 * n
        body_len = sum(len(x) for x in nodes)
        upper = psize - body_len
        assert upper >= lower, "page overflow"
        buf = bytearray(psize)
        _PAGEHDR.pack_into(buf, 0, len(pages), 0, flags, lower, upper)
        off = psize
        ptrs = []
        for nd in nodes:
            off -= len(nd)
            buf[off:off + len(nd)] = nd
            ptrs.append(off)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, p)
        pages.append(bytes(buf))
        return len(pages) - 1

    def emit_overflow(value: bytes) -> int:
        npages = (PAGEHDRSZ + len(value) + psize - 1) // psize
        first = len(pages)
        buf = bytearray(npages * psize)
        struct.pack_into("<QHHI", buf, 0, first, 0, P_OVERFLOW, npages)
        buf[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
        for i in range(npages):
            pages.append(bytes(buf[i * psize:(i + 1) * psize]))
        return first

    # pack leaves greedily
    max_inline = psize // 2 - 32
    leaf_nodes: List[bytes] = []
    leaf_first_keys: List[bytes] = []
    leaves: List[int] = []
    cur: List[bytes] = []
    cur_first: Optional[bytes] = None

    def flush_leaf():
        nonlocal cur, cur_first
        if cur:
            leaves.append(emit_page(P_LEAF, cur))
            leaf_first_keys.append(cur_first)
            cur, cur_first = [], None

    # overflow pages must be emitted as encountered; buffer leaf nodes with
    # resolved overflow pgnos
    for key, value in items:
        if len(value) > max_inline:
            ov = emit_overflow(value)
            nd = node_bytes(len(value) & 0xFFFF, len(value) >> 16, F_BIGDATA,
                            key, struct.pack("<Q", ov))
        else:
            nd = node_bytes(len(value) & 0xFFFF, len(value) >> 16, 0, key, value)
        if cur and (PAGEHDRSZ + 2 * (len(cur) + 1)
                    + sum(len(x) for x in cur) + len(nd)) > psize:
            flush_leaf()
        if not cur:
            cur_first = key
        cur.append(nd)
    flush_leaf()

    # build branch levels bottom-up until a single root page remains
    # (arbitrary depth — a 4 KB branch page holds ~90 md5-keyed children,
    # so >~8k big-value items need two levels, LSUN-scale needs three)
    n_branch_pages = 0
    if not leaves:
        root, depth = INVALID_PGNO, 0
    else:
        level_pages, level_keys = leaves, leaf_first_keys
        depth = 1
        while len(level_pages) > 1:
            new_pages: List[int] = []
            new_keys: List[bytes] = []
            cur_nodes: List[bytes] = []
            cur_first: Optional[bytes] = None

            def bnode(pg: int, key: bytes) -> bytes:
                return node_bytes(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                                  (pg >> 32) & 0xFFFF, key)

            for pg, k in zip(level_pages, level_keys):
                # node 0's key is ignored by lookup (leftmost) — keep empty
                nd = bnode(pg, b"" if not cur_nodes else k)
                if cur_nodes and (PAGEHDRSZ + 2 * (len(cur_nodes) + 1)
                                  + sum(len(x) for x in cur_nodes)
                                  + len(nd)) > psize:
                    new_pages.append(emit_page(P_BRANCH, cur_nodes))
                    new_keys.append(cur_first)
                    cur_nodes, cur_first = [], None
                    nd = bnode(pg, b"")
                if not cur_nodes:
                    cur_first = k
                cur_nodes.append(nd)
            new_pages.append(emit_page(P_BRANCH, cur_nodes))
            new_keys.append(cur_first)
            n_branch_pages += len(new_pages)
            level_pages, level_keys = new_pages, new_keys
            depth += 1
        root = level_pages[0]

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(psize)
        _PAGEHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        _META.pack_into(buf, PAGEHDRSZ, MAGIC, 1, 0, psize * (len(pages) + 2))
        off = PAGEHDRSZ + _META.size
        _DB.pack_into(buf, off, psize, 0, 0, 0, 0, 0, 0, INVALID_PGNO)  # free DB
        nleaf = len(leaves)
        nbranch = n_branch_pages
        novf = len(pages) - 2 - nleaf - nbranch
        _DB.pack_into(buf, off + _DB.size, 0, 0, depth, nbranch, nleaf, novf,
                      len(items), root)
        struct.pack_into("<QQ", buf, off + 2 * _DB.size, len(pages) - 1, txnid)
        return bytes(buf)

    pages[0] = meta_page(0, 1)
    pages[1] = meta_page(1, 0)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "data.mdb")
    with open(out, "wb") as f:
        f.write(b"".join(pages))
    # empty lock file for tool compatibility
    open(os.path.join(path, "lock.mdb"), "wb").close()
    return out
