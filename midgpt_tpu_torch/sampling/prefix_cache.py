"""Cross-request prefix cache: a copy-on-write radix tree over the paged
KV pool (the port's own copy of midgpt_tpu/sampling/prefix_cache.py, which
is framework-free: the same names, structure and rules).

Production traffic is dominated by shared system prompts and few-shot
templates, yet a paged engine without this module re-prefills every request
from token 0 — including preemption victims re-prefilling their OWN prompt.
The fix needs no device-side machinery at all: the page table is already a
plain input of every decode step and of every captured CUDA graph
(sampling/serve.py, sampling/graphs.py), so two slots whose page-table rows
contain the same physical page READ the same K/V. Sharing is therefore
purely a host-allocator question — which this trie answers — and the set
of captured graphs does not change by construction.

Structure. A compressed radix (Patricia) trie at PAGE granularity: one
`_Entry` per physical page, keyed by the `page_size`-token content that was
written into it; consecutive single-child entries are stored as one
`_Node`'s entry chain, and divergence points split the chain into children
keyed by their first page's tokens. Each entry carries a refcount (live
slot readers) and an LRU stamp.

Sharing rules — why readers can never observe a torn page:

  * Only FULL, FINISHED pages enter the trie: `insert_live` shares a
    prompt's `len(prompt) // page_size` complete pages at prefill
    completion, and `release` absorbs a departing slot's complete committed
    pages. The engine never writes a position below its committed length,
    so a trie page is immutable from the moment it becomes shareable.
  * `match` hands out at most `(len(prompt) - 1) // page_size` pages (the
    engine passes `max_tokens = len(prompt) - 1`), so every request
    re-prefills at least its final prompt token — the logits that seed the
    first generated token always come from a live prefill chunk.
  * The copy-on-write tail is REPREFILL, not memcpy: a page the matcher had
    to stop short of (cap hit or the prompt ends mid-page while a trie page
    carries the same leading tokens) is recomputed into a freshly allocated
    private page through the existing scatter write path
    (GPT.prefill_paged_chunk). `MatchResult.cow_truncated` marks exactly
    those admissions; nothing ever copies pool bytes host-side.
  * In int8 pool mode the per-page absmax scales are indexed by PHYSICAL
    page alongside the int8 columns (models/gpt.py PagedKVCache), so
    sharing a page shares its quantization scales with zero extra
    bookkeeping (pinned by tests/test_torch_prefix_cache.py).

Lifecycle. `match` (admission) takes a reference on every handed-out page;
`release` (finish/cancel/timeout/preemption) drops them, donates the
departing slot's private complete pages to the trie with refcount 0, and
returns the pages that go back to the allocator (partial tails, and pages
whose content already lives in the trie under a different physical page).
A preempted slot therefore leaves its history IN the trie and re-matches
it on readmission — resume re-prefills only the sub-page tail instead of
the whole folded prompt (pinned by tests/test_torch_prefix_cache.py).

Eviction. `evict` frees only refcount-0 entries, deepest-first within a
branch (a page cannot leave while pages that extend it remain) and
globally least-recently-used first — so a hot shared node is reclaimed
LRU-last and a referenced one never. The engine calls it when the
allocator runs dry, BEFORE considering slot preemption; the
`evict_shared_prefix` chaos fault (robustness/faults.py) calls it with
`force_all=True` to prove a forced flush never corrupts a live reader.
"""

from __future__ import annotations

import dataclasses
import typing as tp


@dataclasses.dataclass
class MatchResult:
    """`match` outcome: `pages` map into the new slot's page table verbatim
    (prefill skipped for `tokens = len(pages) * page_size` positions);
    `cow_truncated` flags that a trie page carrying the same leading tokens
    existed past the match end — the admission's tail re-prefill is a
    copy-on-write event, not a plain miss."""

    pages: tp.List[int]
    tokens: int
    cow_truncated: bool


class _Entry:
    """One shareable physical page: `key` is the page_size-token content
    written into it, `refs` counts live slot readers, `last_use` is the
    trie-clock LRU stamp."""

    __slots__ = ("key", "page", "refs", "last_use")

    def __init__(self, key: tp.Tuple[int, ...], page: int, refs: int, tick: int):
        self.key = key
        self.page = page
        self.refs = refs
        self.last_use = tick

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_Entry(page={self.page}, refs={self.refs})"


class _Node:
    """A run of single-successor entries (path compression) plus children
    keyed by their first entry's token tuple. The root holds no entries."""

    __slots__ = ("entries", "children", "parent")

    def __init__(self, entries: tp.List[_Entry], parent: tp.Optional["_Node"]):
        self.entries = entries
        self.children: tp.Dict[tp.Tuple[int, ...], "_Node"] = {}
        self.parent = parent


class PrefixCache:
    """Host-side page-granular radix trie (module docstring). Pure host
    code: it deals in physical page INDICES only and never touches device
    memory — the engine moves the returned indices between its allocator
    and its page tables."""

    def __init__(self, page_size: int):
        assert page_size > 0
        self.page_size = page_size
        self._root = _Node([], None)
        self._tick = 0  # monotonic LRU clock (bumped per trie operation)
        self._n_pages = 0  # entries currently held (refs 0 included)
        # Spill hook (ServeEngine.attach_spill sets it to hand the page to
        # a sampling/fleet.py SpillTier): called per evicted entry
        # with (full_prefix_tokens, page) BEFORE the page returns to the
        # allocator, where full_prefix_tokens is the entry's complete token
        # prefix from the root (the spill tier's lookup key must be
        # position-dependent — the same page content at a different depth is
        # different KV). Host-only; the page's device bytes are still intact
        # when the hook runs because the allocator hasn't reissued the page.
        self.on_evict: tp.Optional[
            tp.Callable[[tp.Tuple[int, ...], int], None]
        ] = None

    # -- keys ----------------------------------------------------------

    def _key_at(self, tokens, d: int) -> tp.Tuple[int, ...]:
        ps = self.page_size
        return tuple(int(t) for t in tokens[d * ps : (d + 1) * ps])

    # -- read side -----------------------------------------------------

    def match(self, tokens, *, max_tokens: tp.Optional[int] = None) -> MatchResult:
        """Greedy longest-prefix walk; every returned page is referenced
        (the caller OWNS one ref per page until the paired `release`).
        `max_tokens` caps the match so the caller always re-prefills the
        positions past it (the engine passes len(prompt) - 1)."""
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        max_full = limit // ps
        self._tick += 1
        pages: tp.List[int] = []
        node, idx, d = self._root, 0, 0
        while d < max_full:
            key = self._key_at(tokens, d)
            if idx < len(node.entries):
                e = node.entries[idx]
                if e.key != key:
                    break
                e.refs += 1
                e.last_use = self._tick
                pages.append(e.page)
                idx += 1
                d += 1
            else:
                child = node.children.get(key)
                if child is None:
                    break
                node, idx = child, 0
        # COW detection: does a trie page's content extend past where we
        # stopped, matching everything we still have to place in the next
        # page? Then the tail re-prefill recomputes (part of) a shared page
        # into a private one — the copy-on-write event the stats report.
        rest = tuple(int(t) for t in tokens[d * ps : min(len(tokens), (d + 1) * ps)])
        cow = False
        if rest:
            if idx < len(node.entries):
                cow = node.entries[idx].key[: len(rest)] == rest
            else:
                cow = any(k[: len(rest)] == rest for k in node.children)
        return MatchResult(pages=pages, tokens=len(pages) * ps, cow_truncated=cow)

    def peek(self, tokens, *, max_tokens: tp.Optional[int] = None) -> int:
        """Side-effect-free match probe: how many pages WOULD match. Feeds
        the engine's refcount-aware backpressure accounting
        (`ServeEngine._backlog_pages`); takes no references, moves no LRU
        stamps."""
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        max_full = limit // ps
        n = 0
        node, idx = self._root, 0
        while n < max_full:
            key = self._key_at(tokens, n)
            if idx < len(node.entries):
                if node.entries[idx].key != key:
                    break
                idx += 1
                n += 1
            else:
                child = node.children.get(key)
                if child is None:
                    break
                node, idx = child, 0
        return n

    # -- write side ----------------------------------------------------

    def insert_live(self, tokens, pages: tp.List[int], n_shared: int) -> int:
        """Share a live slot's complete prompt pages at prefill completion
        (they are immutable from here on — the engine only writes positions
        >= len(prompt)). `pages[:n_shared]` are already trie entries the
        slot references; the remainder is offered. Newly inserted entries
        start at refcount 1 — the inserting slot reads them. Returns the
        slot's new n_shared: the insert stops early when the trie already
        holds the same content under a DIFFERENT physical page (the slot
        keeps reading its private copy; `release` reconciles later)."""
        ps = self.page_size
        full = len(tokens) // ps
        self._tick += 1
        node, idx, d = self._root, 0, 0
        while d < full:
            key = self._key_at(tokens, d)
            if idx < len(node.entries):
                e = node.entries[idx]
                if e.key == key:
                    if d < n_shared:
                        assert e.page == pages[d], "shared prefix diverged"
                    elif e.page != pages[d]:
                        # duplicate content raced in (a sibling slot finished
                        # the same prefix first): stop sharing here
                        return d
                    e.last_use = self._tick
                    idx += 1
                    d += 1
                    continue
                assert d >= n_shared, "shared prefix diverged"
                self._split(node, idx)
            child = node.children.get(key)
            if child is not None:
                node, idx = child, 0
                continue
            self._attach(node, tokens, pages, d, full, refs=1)
            return full
        return full

    def release(self, tokens, pages: tp.List[int], n_shared: int) -> tp.List[int]:
        """A slot departs (finish/cancel/timeout/preemption): drop its refs
        on `pages[:n_shared]`, donate its private COMPLETE pages to the trie
        at refcount 0 (so an identical or resumed request re-matches them),
        and return the pages the allocator gets back — partial tails,
        overallocated growth, and content-duplicates the trie already holds
        under another physical page. `tokens` is the slot's COMMITTED
        content (concat(prompt, generated)[:length])."""
        ps = self.page_size
        full = len(tokens) // ps
        assert n_shared <= full <= len(pages)
        self._tick += 1
        freed: tp.List[int] = []
        node, idx, d = self._root, 0, 0
        while d < full:
            key = self._key_at(tokens, d)
            if idx < len(node.entries):
                e = node.entries[idx]
                if e.key == key:
                    if d < n_shared:
                        assert e.page == pages[d], "shared prefix diverged"
                        e.refs -= 1
                        assert e.refs >= 0, "refcount underflow"
                    else:
                        assert e.page != pages[d], "page owned twice"
                        freed.append(pages[d])  # content-duplicate
                    e.last_use = self._tick
                    idx += 1
                    d += 1
                    continue
                assert d >= n_shared, "shared prefix diverged"
                self._split(node, idx)
            child = node.children.get(key)
            if child is not None:
                node, idx = child, 0
                continue
            self._attach(node, tokens, pages, d, full, refs=0)
            d = full
        freed.extend(pages[full:])
        return freed

    def evict(self, n_wanted: int, *, force_all: bool = False) -> tp.List[int]:
        """Reclaim up to `n_wanted` refcount-0 pages (every one of them
        with `force_all=True` — the evict_shared_prefix chaos fault).
        Order: deepest entry of a leaf branch first (a page never leaves
        while pages extending it remain) and least-recently-used across
        leaves — a hot shared node goes LRU-last, a referenced node never
        goes at all. Returns the freed physical pages."""
        freed: tp.List[int] = []
        while force_all or len(freed) < n_wanted:
            best: tp.Optional[_Node] = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node.children or not node.entries:
                    continue  # interior node, or the (empty) root
                e = node.entries[-1]
                if e.refs == 0 and (
                    best is None or e.last_use < best.entries[-1].last_use
                ):
                    best = node
            if best is None:
                break
            if self.on_evict is not None:
                self.on_evict(self._full_prefix(best), best.entries[-1].page)
            e = best.entries.pop()
            freed.append(e.page)
            self._n_pages -= 1
            if not best.entries:
                self._detach(best)
        return freed

    def _full_prefix(self, node: _Node) -> tp.Tuple[int, ...]:
        """The complete token prefix of `node`'s LAST entry, reconstructed
        by walking the parent chain — the position-dependent identity a
        spill tier must key on (module docstring: a page's KV depends on
        every token before it, not just the page_size tokens inside it)."""
        chain: tp.List[_Node] = []
        n: tp.Optional[_Node] = node
        while n is not None and n is not self._root:
            chain.append(n)
            n = n.parent
        toks: tp.List[int] = []
        for anc in reversed(chain):
            for e in anc.entries:
                toks.extend(e.key)
        return tuple(toks)

    # -- accounting (tests, chaos conservation, backpressure) ----------

    def page_count(self) -> int:
        """Entries currently held, referenced or not. The chaos/page
        conservation invariant with the cache enabled is
        `allocator.free_count + page_count() == num_pages - 1` once the
        engine drains (sampling/ops.py assert_conserved)."""
        return self._n_pages

    def referenced_page_count(self) -> int:
        """Entries with at least one live reader — the unreclaimable part
        of the trie's footprint, charged once (not per reader) by the
        engine's backpressure accounting."""
        return sum(1 for e in self._iter_entries() if e.refs > 0)

    def pages_held(self) -> tp.Set[int]:
        return {e.page for e in self._iter_entries()}

    def referenced_pages(self) -> tp.Set[int]:
        """Physical pages with at least one live reader — the part of the
        trie's footprint a live pool resize must carry over (resident
        working set, sampling/ops.py resize_pool)."""
        return {e.page for e in self._iter_entries() if e.refs > 0}

    def remap_pages(self, mapping: tp.Mapping[int, int]) -> int:
        """Rewrite every entry's physical page id through `mapping` — the
        trie re-seed step of a live pool resize (sampling/ops.py): the
        token->content structure and all refcounts survive; only the
        physical addressing changes, in lockstep with the slot page lists
        and the migrated pool. Every held page must be in `mapping`
        (resize migrates the full resident set). Returns entries remapped."""
        n = 0
        for e in self._iter_entries():
            e.page = mapping[e.page]
            n += 1
        return n

    def stats(self) -> tp.Dict[str, int]:
        ents = list(self._iter_entries())
        return {
            "pages": len(ents),
            "referenced": sum(1 for e in ents if e.refs > 0),
            "refs": sum(e.refs for e in ents),
        }

    def _iter_entries(self) -> tp.Iterator[_Entry]:
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield from node.entries

    # -- structure -----------------------------------------------------

    def _split(self, node: _Node, idx: int) -> None:
        """Divergence inside a compressed chain: entries[idx:] (and the
        node's children) move under a new child so a sibling branch can
        attach at depth idx. idx >= 1 always — a walk only enters a node
        after matching its first entry."""
        assert 0 < idx < len(node.entries)
        tail = _Node(node.entries[idx:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        node.entries = node.entries[:idx]
        node.children = {tail.entries[0].key: tail}

    def _attach(
        self, node: _Node, tokens, pages: tp.List[int], d: int, full: int, refs: int
    ) -> None:
        entries = [
            _Entry(self._key_at(tokens, i), pages[i], refs, self._tick)
            for i in range(d, full)
        ]
        if not entries:
            return
        assert entries[0].key not in node.children
        node.children[entries[0].key] = _Node(entries, node)
        self._n_pages += full - d

    def _detach(self, node: _Node) -> None:
        parent = node.parent
        for key, child in list(parent.children.items()):
            if child is node:
                del parent.children[key]
                return
        raise AssertionError("orphan trie node")  # pragma: no cover
