"""Per-replica prefix cache: a radix trie of resident KV page prefixes.

Serving traffic is heavily self-similar — shared system prompts, few-shot
preambles, multi-turn sessions that resend the whole conversation — so
the K/V a replica computed for one request is very often a bit-exact
prefix of the next request's.  (K/V at position ``p`` depends only on
tokens ``<= p`` under causal attention with absolute RoPE, so identical
token prefixes imply identical page contents.)  This module keeps those
pages *resident* after their writer evicts and hands them to matching
joiners instead of recomputing prefill:

* the trie is keyed at **page granularity**: each node owns one physical
  page of the :class:`~repro_torch.serve.kvcache.PagedKVPool` and the tuple of
  token ids written into it (full nodes carry exactly ``page`` tokens;
  *partial* leaves — a finished sequence's last, half-filled page — carry
  fewer);
* :meth:`match` walks the trie greedily and returns the longest resident
  prefix, capped one token short of the prompt so the joiner always has a
  suffix to run (the last prompt token's logits must be recomputed);
* full-block hits are **shared** (``PagedKVPool.share`` refcount, zero
  copies — the joiner's writes all land past them), a partial-block hit
  is **copy-on-write**: the joiner extends the page in place, so it gets
  a cloned page (``make_clone_pages``) while other referents keep
  reading the original;
* residency is refcounted through :meth:`PagedKVPool.retain`; when the
  pool cannot meet a reservation it calls :meth:`evict` (installed as
  ``pool.on_pressure``), which surrenders least-recently-used leaves
  until the pressure clears — so resident prefixes never block admission.

The cache is deliberately engine-agnostic: the same instance backs the
real :class:`~repro_torch.serve.engine.ContinuousEngine` (device pages) and the
fleet simulator (accounting-only pool), and the
:class:`~repro_torch.serve.fleet.router.FleetRouter` scores placement with
:meth:`peek` (no LRU side effects).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

_NODE_IDS = itertools.count()


@dataclass
class _Node:
    """One resident page: the tokens written into it + trie links."""

    tokens: Tuple[int, ...]
    page_id: int
    parent: Optional["_Node"]
    n_tokens: int                       # == page for full nodes, < page partial
    last_use: int = 0
    node_id: int = field(default_factory=lambda: next(_NODE_IDS))
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    partials: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)


@dataclass
class PrefixMatch:
    """Longest resident prefix for one prompt.

    ``n_tokens = page * len(full_pages) + partial_len``; ``partial_page``
    (when set) must be copy-on-write cloned by the joiner before writing.
    ``match`` is a side-effect-free trial — the caller passes the match
    back through :meth:`PrefixCache.commit` once the admission that used
    it actually succeeds, which is when lookup/hit counters and LRU
    clocks move.
    """

    n_tokens: int = 0
    full_pages: List[int] = field(default_factory=list)
    partial_page: Optional[int] = None
    partial_len: int = 0
    n_prompt: int = 0                       # looked-up prompt length
    nodes: List["_Node"] = field(default_factory=list)   # for commit's LRU


class PrefixCache:
    """Radix trie of resident page prefixes over one :class:`PagedKVPool`."""

    def __init__(self, pool, max_pages: Optional[int] = None):
        self.pool = pool
        self.page = pool.page
        # bound residency below pool capacity so the cache can never starve
        # admissions even before pressure eviction kicks in
        self.max_pages = max_pages if max_pages is not None \
            else max(pool.capacity_pages // 2, 1)
        self._root = _Node(tokens=(), page_id=-1, parent=None, n_tokens=0)
        self._n_resident = 0
        self._clock = 0
        # counters (exported as fleet_prefix_* metrics)
        self.n_lookups = 0
        self.n_hits = 0
        self.tokens_matched = 0
        self.tokens_looked_up = 0
        self.n_insertions = 0
        self.n_evictions = 0
        pool.on_pressure = self.evict

    # ---- introspection ---------------------------------------------------
    @property
    def n_resident_pages(self) -> int:
        return self._n_resident

    @property
    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from resident pages."""
        return self.tokens_matched / max(self.tokens_looked_up, 1)

    # ---- matching --------------------------------------------------------
    def _walk(self, prompt: np.ndarray, limit: int) -> Tuple[List[_Node], Optional[_Node]]:
        """Greedy trie walk: full-block chain + an optional partial leaf,
        never matching past ``limit`` tokens."""
        chain: List[_Node] = []
        node = self._root
        pos = 0
        while pos + self.page <= limit:
            key = tuple(int(t) for t in prompt[pos:pos + self.page])
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child)
            node = child
            pos += self.page
        best: Optional[_Node] = None
        for key, leaf in node.partials.items():
            if pos + leaf.n_tokens > limit:
                continue
            if tuple(int(t) for t in prompt[pos:pos + leaf.n_tokens]) == key:
                if best is None or leaf.n_tokens > best.n_tokens:
                    best = leaf
        return chain, best

    def peek(self, prompt: Sequence[int]) -> int:
        """Matched-token count for router scoring: no refcounts, no LRU."""
        prompt = np.asarray(prompt)
        chain, partial = self._walk(prompt, limit=len(prompt) - 1)
        return self.page * len(chain) + (partial.n_tokens if partial else 0)

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest resident prefix of ``prompt`` (capped at ``len - 1``).

        A side-effect-free *trial*: no references taken, no counters
        moved, no LRU touched.  The scheduler commits the match — pages
        via :meth:`PagedKVPool.share`, statistics and LRU clocks via
        :meth:`commit` — only once the request's reservation succeeds.
        A head-of-line-blocked request can therefore re-try its match
        every poll without deflating ``hit_rate`` or unfairly keeping
        its (blocked) prefix resident.
        """
        prompt = np.asarray(prompt)
        chain, partial = self._walk(prompt, limit=len(prompt) - 1)
        m = PrefixMatch(full_pages=[n.page_id for n in chain],
                        n_prompt=len(prompt), nodes=list(chain))
        m.n_tokens = self.page * len(chain)
        if partial is not None:
            m.nodes.append(partial)
            m.partial_page = partial.page_id
            m.partial_len = partial.n_tokens
            m.n_tokens += partial.n_tokens
        return m

    def commit(self, match: PrefixMatch) -> None:
        """Book a trial :meth:`match` that admission actually used: count
        the lookup (and hit, if any tokens matched) and refresh the
        matched nodes' LRU clocks.  Call exactly once per admitted
        request, after its page reservation succeeds.  Touching a node
        the reservation's pressure eviction already detached is a no-op —
        the shared pages themselves were pinned across that window."""
        self.n_lookups += 1
        self.tokens_looked_up += match.n_prompt
        self._clock += 1
        for node in match.nodes:
            node.last_use = self._clock
        if match.n_tokens:
            self.n_hits += 1
            self.tokens_matched += match.n_tokens

    # ---- insertion -------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Adopt a finished request's pages: ``tokens`` is its full written
        sequence (prompt + generated), ``pages`` its page table in order.
        Pages backing *new* trie nodes are retained (they survive the
        request's release); pages duplicating existing nodes are left to
        die with the request.  Nodes on the insertion path (walked or
        just created) are shielded from the capacity eviction below —
        evicting the chain tip about to receive a child would detach the
        child from the root, leaking its retained page forever.  When
        every evictable leaf is on the path, adoption stops instead.
        Returns the number of pages adopted."""
        tokens = np.asarray(tokens)
        adopted = 0
        node = self._root
        pos = 0
        self._clock += 1
        path: Set[int] = set()
        for i, pid in enumerate(pages):
            n_left = len(tokens) - pos
            if n_left <= 0:
                break
            if n_left >= self.page:
                key = tuple(int(t) for t in tokens[pos:pos + self.page])
                child = node.children.get(key)
                if child is None:
                    if self._n_resident >= self.max_pages \
                            and not self._evict_one(protect=path):
                        break
                    child = _Node(tokens=key, page_id=pid, parent=node,
                                  n_tokens=self.page)
                    node.children[key] = child
                    self.pool.retain([pid])
                    self._n_resident += 1
                    adopted += 1
                child.last_use = self._clock
                path.add(child.node_id)
                node = child
                pos += self.page
            else:
                key = tuple(int(t) for t in tokens[pos:])
                leaf = node.partials.get(key)
                if leaf is None:
                    if self._n_resident >= self.max_pages \
                            and not self._evict_one(protect=path):
                        break
                    leaf = _Node(tokens=key, page_id=pid, parent=node,
                                 n_tokens=n_left)
                    node.partials[key] = leaf
                    self.pool.retain([pid])
                    self._n_resident += 1
                    adopted += 1
                leaf.last_use = self._clock
                break
        if adopted:
            self.n_insertions += 1
        return adopted

    # ---- eviction --------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            out.extend(node.partials.values())
            for child in node.children.values():
                if not child.children and not child.partials:
                    out.append(child)
        return out

    _NO_PROTECT: FrozenSet[int] = frozenset()

    def _evict_one(self, protect: FrozenSet[int] = _NO_PROTECT) -> bool:
        """Drop the least-recently-used evictable leaf (ties: oldest node).
        ``protect`` names node_ids that must survive — the current
        insertion path, whose tip is about to be given a child."""
        leaves = [n for n in self._leaves() if n.node_id not in protect]
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: (n.last_use, n.node_id))
        parent = victim.parent
        if victim.n_tokens < self.page:
            del parent.partials[victim.tokens]
        else:
            del parent.children[victim.tokens]
        self.pool.unretain([victim.page_id])
        self._n_resident -= 1
        self.n_evictions += 1
        return True

    def evict(self, n_pages: int) -> int:
        """Return >= ``n_pages`` pages to the pool's free list if residency
        allows (the ``pool.on_pressure`` hook).  A page still shared by a
        live request stays allocated when the cache's reference drops, so
        eviction keeps going until enough pages *actually* freed."""
        start_free = len(self.pool._free)
        while len(self.pool._free) - start_free < n_pages and self._evict_one():
            pass
        return len(self.pool._free) - start_free

    def clear(self) -> None:
        while self._evict_one():
            pass
