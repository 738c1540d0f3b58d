"""Content-keyed, refcounted shared-prefix page index — the port's copy
of ``repro.serving.prefix_cache`` (pure Python; the port imports nothing
of the JAX package, so it keeps its own).

Host-side companion to the engine's page allocator. Prompt prefixes are
hashed block by block with a *chained* blake2b digest -- each block's key
commits to the scope key, the parent block's digest and the block's
tokens -- so a match at block j implies the whole token prefix
``prompt[: (j+1) * blk]`` matches. The digests are byte for byte the JAX
package's: they are the cache's identity.

The index stores two kinds of entries:

* **full-block** entries: a published, read-only pool page holding ``blk``
  tokens of K/V. A hit maps the page into the new slot's block table and
  takes a reference; the page is recycled only when its refcount drops to
  zero.
* **partial-tail** entries: the publisher's last, partially filled page
  (``r = (S - 1) % blk`` tokens). Tails are never mapped shared -- a hit
  copies the page (copy-on-write) into a freshly popped exclusive page and
  resumes writing at token ``r``. A tail entry holds no reference; it dies
  with the slot that published it (``drop_tail``).

Only the first ``S - 1`` prompt tokens are sharable: the admitted row must
prefill at least its final token to produce its first-token logits.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

__all__ = [
    "PrefixIndex",
    "PrefixHit",
    "chain_digests",
    "sharable_tokens",
]


def sharable_tokens(length: int, blk: int) -> tuple[int, int]:
    """Split a prompt of ``length`` tokens into (full_blocks, tail_tokens).

    Only ``length - 1`` tokens are sharable (the last token is always
    prefilled by the consumer), so a 2-block prompt that exactly fills its
    pages still publishes one full block plus a ``blk - 1``-token tail.
    """
    share = max(0, int(length) - 1)
    return share // blk, share % blk


def chain_digests(scope: bytes, tokens: np.ndarray, blk: int) -> list[bytes]:
    """Chained blake2b digest per full block, plus one tail digest.

    Returns ``f + (1 if r else 0)`` digests for ``f`` full sharable blocks
    and an ``r``-token tail (see :func:`sharable_tokens`).  Digest ``j``
    commits to ``scope || digest[j-1] || tokens[j*blk:(j+1)*blk]``.
    """
    toks = np.asarray(tokens, np.int32)
    f, r = sharable_tokens(toks.shape[0], blk)
    out: list[bytes] = []
    parent = b""
    for j in range(f):
        h = hashlib.blake2b(digest_size=16)
        h.update(scope)
        h.update(parent)
        h.update(toks[j * blk : (j + 1) * blk].tobytes())
        parent = h.digest()
        out.append(parent)
    if r:
        h = hashlib.blake2b(digest_size=16)
        h.update(scope)
        h.update(parent)
        h.update(toks[f * blk : f * blk + r].tobytes())
        out.append(h.digest())
    return out


@dataclasses.dataclass
class PrefixHit:
    """Result of a lookup: what an admission can reuse."""

    full_pages: list[int]      # published pages for matched full blocks
    full_digests: list[bytes]  # their digests (for taking refs)
    tail_page: Optional[int]   # page to CoW-copy, or None
    tail_tokens: int           # tokens already written in tail_page
    start: int                 # first token index the consumer must prefill

    @property
    def matched_blocks(self) -> int:
        return len(self.full_pages)


@dataclasses.dataclass
class _Entry:
    page: int
    refs: int          # 0 for tail entries (never ref-held)
    tail: int          # 0 => full block; >0 => tail token count
    owner: tuple       # (client, slot) that published the entry


class PrefixIndex:
    """Digest -> page map with refcounts.  All methods are host-side.

    Refcount protocol (mirrored by the engine's ``_slot_shared``):

    * ``publish`` registers a page at refs=1 held by the publishing slot.
    * ``ref`` bumps an entry when a hit maps its page into another slot.
    * ``deref`` drops one reference; at zero the entry is removed and the
      page id returned so the allocator can recycle it.
    * tail entries carry refs=0 and die with their publisher via
      ``drop_tail``.
    """

    def __init__(self) -> None:
        self._entries: dict[bytes, _Entry] = {}
        self._by_page: dict[int, bytes] = {}

    # -- introspection -------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def refs_of(self, digest: bytes) -> int:
        return self._entries[digest].refs

    def page_refs(self) -> dict[int, int]:
        """page id -> refcount for every ref-held (full-block) entry."""
        return {e.page: e.refs for e in self._entries.values() if not e.tail}

    def live_pages(self) -> set[int]:
        return {e.page for e in self._entries.values()}

    # -- lookup --------------------------------------------------------
    def lookup(self, scope: bytes, tokens: np.ndarray, blk: int) -> PrefixHit:
        """Longest-prefix match of ``tokens`` against published entries.

        Matching stops at the first missing digest.  A tail match is only
        reported when *every* full block matched and the tail entry's
        token count fits inside the sharable region of this prompt.
        """
        digests = chain_digests(scope, tokens, blk)
        f, r = sharable_tokens(np.asarray(tokens).shape[0], blk)
        pages: list[int] = []
        matched: list[bytes] = []
        for j in range(f):
            e = self._entries.get(digests[j])
            if e is None or e.tail:
                break
            pages.append(e.page)
            matched.append(digests[j])
        tail_page = None
        tail_tokens = 0
        if len(pages) == f and r:
            # our own tail digest only matches an identical r-token tail;
            # also accept a published tail SHORTER than ours by probing the
            # publisher-side digest for each candidate tail length.
            for cand in range(r, 0, -1):
                h = hashlib.blake2b(digest_size=16)
                h.update(scope)
                h.update(matched[-1] if matched else b"")
                h.update(np.asarray(tokens, np.int32)[f * blk : f * blk + cand]
                         .tobytes())
                e = self._entries.get(h.digest())
                if e is not None and e.tail == cand:
                    tail_page, tail_tokens = e.page, cand
                    break
        start = len(pages) * blk + tail_tokens
        return PrefixHit(pages, matched, tail_page, tail_tokens, start)

    # -- publish -------------------------------------------------------
    def publish(self, scope: bytes, tokens: np.ndarray, blk: int,
                pages: list[int], owner: tuple) -> list[int]:
        """Register a just-prefilled slot's prefix pages.

        ``pages`` is the slot's page list in block order.  Full sharable
        blocks become refs=1 entries (the publishing slot holds the ref);
        a non-empty tail becomes a refs=0 tail entry.  Duplicate digests
        (another slot published the same content first) are skipped.
        Returns the page ids that were published as ref-held full blocks
        -- the engine moves exactly those from its exclusive list to its
        shared list.
        """
        digests = chain_digests(scope, tokens, blk)
        f, r = sharable_tokens(np.asarray(tokens).shape[0], blk)
        took: list[int] = []
        for j in range(f):
            d = digests[j]
            if d in self._entries:
                continue
            page = pages[j]
            self._entries[d] = _Entry(page=page, refs=1, tail=0, owner=owner)
            self._by_page[page] = d
            took.append(page)
        if r and f < len(pages):
            d = digests[f]
            if d not in self._entries:
                page = pages[f]
                # a tail page stays exclusive to its owner; index it for
                # CoW lookups but never for shared mapping.
                if page not in self._by_page:
                    self._entries[d] = _Entry(page=page, refs=0, tail=r,
                                              owner=owner)
                    self._by_page[page] = d
        return took

    # -- refcounting ---------------------------------------------------
    def ref(self, digest: bytes) -> int:
        e = self._entries[digest]
        if e.tail:
            raise ValueError("tail entries are copy-on-write, never ref-held")
        e.refs += 1
        return e.page

    def deref(self, page: int) -> bool:
        """Drop one reference on the full-block entry holding ``page``.

        Returns True when the refcount hit zero and the entry was removed
        -- the caller recycles the page into the free pool.
        """
        d = self._by_page.get(page)
        if d is None:
            raise KeyError(f"page {page} is not a published prefix page")
        e = self._entries[d]
        if e.tail:
            raise ValueError(f"page {page} is a tail entry; use drop_tail")
        if e.refs <= 0:
            raise RuntimeError(f"double free of shared prefix page {page}")
        e.refs -= 1
        if e.refs == 0:
            del self._entries[d]
            del self._by_page[page]
            return True
        return False

    def drop_tail(self, owner: tuple) -> None:
        """Invalidate tail entries owned by a retiring slot."""
        dead = [d for d, e in self._entries.items()
                if e.tail and e.owner == tuple(owner)]
        for d in dead:
            del self._by_page[self._entries[d].page]
            del self._entries[d]

    # -- persistence ---------------------------------------------------
    def state(self) -> dict:
        return {
            d: (e.page, e.refs, e.tail, tuple(e.owner))
            for d, e in self._entries.items()
        }

    @classmethod
    def from_state(cls, state: dict) -> "PrefixIndex":
        idx = cls()
        for d, (page, refs, tail, owner) in state.items():
            idx._entries[d] = _Entry(page=int(page), refs=int(refs),
                                     tail=int(tail), owner=tuple(owner))
            idx._by_page[int(page)] = d
        return idx
