"""Hashed-bucket address book — eclipse-resistant peer address storage.

Reference: p2p/pex/addrbook.go:1-947 + params.go. The structure that
matters for eclipse resistance is reproduced faithfully:

- 256 NEW buckets + 64 OLD buckets, 64 entries each; placement is keyed
  by a random per-book secret, so an attacker cannot predict which bucket
  an address lands in (addrbook.go:830-878 calcNewBucket/calcOldBucket);
- addresses from one source /16 group spread over at most 32 new buckets,
  one address may appear in at most 4 new buckets (params.go);
- an address is promoted NEW -> OLD only by markGood (a completed
  handshake + useful behavior), old buckets evict by demoting their
  oldest entry back to NEW (moveToOld, addrbook.go:757-800) — a flood of
  unproven addresses can never displace proven-good peers;
- overflowing NEW buckets first expire "bad" entries (stale / many
  failed attempts), else drop the oldest (expireNew :739).

Persistence stays JSON (same file the flat book used, version-bumped).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Optional

from .transport import NetAddress

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
NEW_BUCKETS_PER_GROUP = 32
OLD_BUCKETS_PER_GROUP = 4
MAX_NEW_BUCKETS_PER_ADDRESS = 4
NUM_RETRIES = 3  # attempts without success before an address is "bad"
MAX_FAILURES = 10
NUM_MISSING_SECONDS = 7 * 24 * 3600  # not seen in this long => stale


@dataclass
class KnownAddress:
    addr: str  # "id@host:port"
    src: str = ""  # where we learned it ("" = self/config)
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"  # "new" | "old"
    buckets: list = field(default_factory=list)  # bucket indices

    def is_old(self) -> bool:
        return self.bucket_type == "old"

    def is_bad(self, now: float) -> bool:
        """expired/failed entries, evicted first (knownaddress.go isBad)."""
        if self.last_attempt and now - self.last_attempt < 60:
            return False  # tried recently: give it a grace minute
        if self.last_success == 0 and self.attempts >= NUM_RETRIES:
            return True
        if self.attempts >= MAX_FAILURES:
            return True
        seen = max(self.last_success, self.last_attempt)
        return bool(seen) and now - seen > NUM_MISSING_SECONDS


def _group(addr_str: str) -> str:
    """Source group: /16 for IPv4 addresses, the hostname otherwise
    (addrbook.go:886 groupKey, simplified: no RFC6145/Tor classes)."""
    host = addr_str.split("@")[-1].rsplit(":", 1)[0]
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return parts[0] + "." + parts[1]
    return host


def _h64(*parts: bytes) -> int:
    return int.from_bytes(
        hashlib.sha256(b"\x1f".join(parts)).digest()[:8], "big"
    )


class AddrBook:
    """Public surface unchanged from the flat book (pex.py's consumer):
    add_address/mark_attempt/mark_good/remove_address/pick_address/
    get_selection/size/save."""

    def __init__(self, path: str = "", our_id: str = ""):
        self._path = path
        self._our_id = our_id
        self._key = secrets.token_bytes(24)
        self._addrs: dict[str, KnownAddress] = {}  # node id -> entry
        self._new: list[dict[str, KnownAddress]] = [
            {} for _ in range(NEW_BUCKET_COUNT)
        ]
        self._old: list[dict[str, KnownAddress]] = [
            {} for _ in range(OLD_BUCKET_COUNT)
        ]
        if path and os.path.exists(path):
            try:
                self._load()
            except Exception:
                # a corrupt on-disk book (crash mid-save, hostile edit)
                # must not wedge node startup: the book is a best-effort
                # cache — start over empty (reference go-fuzz addrbook
                # target asserts no panic on arbitrary input)
                self._addrs = {}
                self._new = [{} for _ in range(NEW_BUCKET_COUNT)]
                self._old = [{} for _ in range(OLD_BUCKET_COUNT)]

    # --- bucket placement (addrbook.go:830-878) ---------------------------

    def _calc_new_bucket(self, addr: str, src: str) -> int:
        h1 = _h64(self._key, _group(addr).encode(), _group(src).encode())
        bucket = h1 % NEW_BUCKETS_PER_GROUP
        h2 = _h64(
            self._key, _group(src).encode(), str(bucket).encode()
        )
        return h2 % NEW_BUCKET_COUNT

    def _calc_old_bucket(self, addr: str) -> int:
        h1 = _h64(self._key, addr.encode())
        bucket = h1 % OLD_BUCKETS_PER_GROUP
        h2 = _h64(
            self._key, _group(addr).encode(), str(bucket).encode()
        )
        return h2 % OLD_BUCKET_COUNT

    # --- mutation ---------------------------------------------------------

    def add_address(
        self, addr: NetAddress, src: Optional[NetAddress] = None
    ) -> bool:
        """Into a NEW bucket; an already-known NEW address is re-added from
        a different source only probabilistically (1/2^buckets), capped at
        4 new buckets (addrbook.go:210,676-736)."""
        if not addr.id or addr.id == self._our_id:
            return False
        src_s = str(src) if src is not None else ""
        ka = self._addrs.get(addr.id)
        if ka is not None:
            if ka.is_old():
                return False
            if len(ka.buckets) >= MAX_NEW_BUCKETS_PER_ADDRESS:
                return False
            # probabilistic re-add from a new source
            if secrets.randbelow(1 << len(ka.buckets)) != 0:
                return False
        else:
            ka = KnownAddress(addr=str(addr), src=src_s)
            self._addrs[addr.id] = ka
        b = self._calc_new_bucket(ka.addr, src_s or ka.src)
        if b in ka.buckets:
            return False
        self._add_to_new_bucket(addr.id, ka, b)
        return True

    def _add_to_new_bucket(self, nid: str, ka: KnownAddress, b: int) -> None:
        bucket = self._new[b]
        if nid in bucket:
            return
        if len(bucket) >= BUCKET_SIZE:
            self._expire_new(b)
        bucket[nid] = ka
        ka.buckets.append(b)

    def _expire_new(self, b: int) -> None:
        """Evict a bad entry, else the oldest (addrbook.go:739-755)."""
        bucket = self._new[b]
        now = time.time()
        victim = None
        for nid, ka in bucket.items():
            if ka.is_bad(now):
                victim = nid
                break
        if victim is None:
            victim = min(
                bucket,
                key=lambda n: max(
                    bucket[n].last_success, bucket[n].last_attempt
                )
                or 0,
            )
        self._remove_from_new_bucket(victim, b)

    def _remove_from_new_bucket(self, nid: str, b: int) -> None:
        ka = self._new[b].pop(nid, None)
        if ka is None:
            return
        if b in ka.buckets:
            ka.buckets.remove(b)
        if not ka.buckets:
            self._addrs.pop(nid, None)

    def mark_attempt(self, node_id: str) -> None:
        ka = self._addrs.get(node_id)
        if ka:
            ka.attempts += 1
            ka.last_attempt = time.time()

    def mark_good(self, node_id: str) -> None:
        """Promote to OLD (addrbook.go:322-337 MarkGood + moveToOld)."""
        ka = self._addrs.get(node_id)
        if ka is None:
            return
        ka.attempts = 0
        ka.last_success = time.time()
        if ka.is_old():
            return
        # remove from all new buckets
        for b in list(ka.buckets):
            self._new[b].pop(node_id, None)
        ka.buckets.clear()
        ob = self._calc_old_bucket(ka.addr)
        bucket = self._old[ob]
        if len(bucket) >= BUCKET_SIZE:
            # demote the oldest old entry back to a new bucket (:781-795)
            oldest = min(
                bucket, key=lambda n: bucket[n].last_success or 0
            )
            demoted = bucket.pop(oldest)
            demoted.bucket_type = "new"
            demoted.buckets.clear()
            nb = self._calc_new_bucket(demoted.addr, demoted.src)
            self._add_to_new_bucket(oldest, demoted, nb)
        ka.bucket_type = "old"
        ka.buckets = [ob]
        bucket[node_id] = ka

    def remove_address(self, node_id: str) -> None:
        ka = self._addrs.pop(node_id, None)
        if ka is None:
            return
        table = self._old if ka.is_old() else self._new
        for b in ka.buckets:
            table[b].pop(node_id, None)

    # --- selection --------------------------------------------------------

    def n_old(self) -> int:
        return sum(1 for ka in self._addrs.values() if ka.is_old())

    def n_new(self) -> int:
        return sum(1 for ka in self._addrs.values() if not ka.is_old())

    def pick_address(
        self, exclude: set[str], bias_new: int = 30
    ) -> Optional[NetAddress]:
        """sqrt-correlation biased pick from a random non-empty bucket
        (addrbook.go:267-320 PickAddress)."""
        import math

        n_old, n_new = self.n_old(), self.n_new()
        if n_old + n_new == 0:
            return None
        bias_new = max(0, min(100, bias_new))
        old_corr = math.sqrt(n_old) * (100.0 - bias_new)
        new_corr = math.sqrt(n_new) * bias_new
        rnd = secrets.randbelow(10**9) / 10**9
        pick_old = (new_corr + old_corr) * rnd < old_corr
        if (pick_old and n_old == 0) or (not pick_old and n_new == 0):
            pick_old = not pick_old
        table = self._old if pick_old else self._new
        candidates = [
            (nid, ka)
            for bucket in table
            for nid, ka in bucket.items()
            if nid not in exclude and ka.attempts < MAX_FAILURES
        ]
        if not candidates:
            return None
        nid, ka = candidates[secrets.randbelow(len(candidates))]
        return NetAddress.parse(ka.addr)

    def get_selection(self, max_n: int = 30) -> list[NetAddress]:
        addrs = [NetAddress.parse(ka.addr) for ka in self._addrs.values()]
        secrets.SystemRandom().shuffle(addrs)
        return addrs[:max_n]

    def size(self) -> int:
        return len(self._addrs)

    # --- persistence ------------------------------------------------------

    def save(self) -> None:
        if not self._path:
            return
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        data = {
            "version": 2,
            "key": self._key.hex(),
            "addrs": {
                nid: {
                    "addr": ka.addr,
                    "src": ka.src,
                    "attempts": ka.attempts,
                    "bucket_type": ka.bucket_type,
                    "buckets": ka.buckets,
                    "last_success": ka.last_success,
                    "last_attempt": ka.last_attempt,
                }
                for nid, ka in self._addrs.items()
            },
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, self._path)

    def _load(self) -> None:
        with open(self._path) as f:
            data = json.load(f)
        if "version" not in data:  # flat v1 book: re-bucket everything
            for nid, d in data.items():
                try:
                    na = NetAddress.parse(d["addr"])
                except (ValueError, KeyError):
                    continue
                self.add_address(na)
                if d.get("bucket") == "old":
                    self.mark_good(nid)
            return
        self._key = bytes.fromhex(data["key"])
        for nid, d in data["addrs"].items():
            ka = KnownAddress(
                addr=d["addr"],
                src=d.get("src", ""),
                attempts=d.get("attempts", 0),
                bucket_type=d.get("bucket_type", "new"),
                buckets=list(d.get("buckets", [])),
                last_success=d.get("last_success", 0.0),
                last_attempt=d.get("last_attempt", 0.0),
            )
            self._addrs[nid] = ka
            table = self._old if ka.is_old() else self._new
            for b in ka.buckets:
                if 0 <= b < len(table):
                    table[b][nid] = ka
