"""libstdc++ std::unordered_map emulation (iteration order only).

The reference writes CellReads.stats by iterating a std::unordered_map
(source/SoloFeature_statsOutput.cpp:102); byte-identical output therefore
requires replicating libstdc++'s _Hashtable node order (hashtable.h
_M_insert_bucket_begin): every new node becomes the FIRST node of its
bucket; if the bucket was empty the node is linked at the head of the
single global forward-list, otherwise it is linked in place of the bucket's
current first node.  Rehashing (_M_rehash_aux) walks the global list in
order re-inserting with the same primitive.  Hash for integral keys is the
identity; bucket = key % bucket_count.  Growth follows _Prime_rehash_policy
(max_load_factor 1.0, growth factor 2, prime bucket counts).  Validated
against g++-compiled probes in tests/test_torch_solo_jax.py.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

# gcc libstdc++ __prime_list (src/shared/hashtable-aux.cc) — first entries
_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 103, 109, 113, 127, 137, 139, 149, 157, 167, 179,
    193, 199, 211, 227, 241, 257, 277, 293, 313, 337, 359, 383, 409, 439,
    467, 503, 541, 577, 619, 661, 709, 761, 823, 887, 953, 1031, 1109, 1193,
    1289, 1381, 1493, 1613, 1741, 1879, 2029, 2179, 2357, 2549, 2753, 2971,
    3209, 3469, 3739, 4027, 4349, 4703, 5087, 5503, 5953, 6427, 6949, 7517,
    8123, 8783, 9497, 10273, 11113, 12011, 12983, 14033, 15173, 16411, 17749,
    19183, 20753, 22447, 24281, 26267, 28411, 30727, 33223, 35933, 38873,
    42043, 45481, 49201, 53201, 57557, 62233, 67307, 72817, 78779, 85229,
    92203, 99733, 107897, 116731, 126271, 136607, 147793, 159871, 172933,
    187091, 202409, 218971, 236897, 256279, 277261, 299951, 324503, 351061,
    379787, 410857, 444487, 480881, 520241, 562841, 608903, 658753, 712697,
    771049, 834181, 902483, 976369, 1056323, 1142821, 1236397, 1337629,
    1447153, 1565659, 1693859, 1832561, 1982627, 2144977, 2320627, 2510653,
    2716249, 2938679, 3179303, 3439651, 3721303, 4026031, 4355707, 4712381,
    5097979, 5515729, 5967347, 6456007, 6984629, 7556579, 8175383, 8844859,
    9569143, 10352717, 11200489, 12117689, 13109983, 14183539, 15343807,
    16601593, 17961079, 19431899, 21023161, 22744717, 24607243, 26622317,
    28802401, 31160981, 33712729, 36473443, 39460231, 42691603, 46187573,
    49973887, 54066041, 58494037, 63284281, 68466337, 74072737, 80139101,
    86702333, 93803467, 101485507,
]
# __fast_bkt lookup for small n (hashtable_c++0x.cc _M_next_bkt); n==0 -> 1
_FAST_BKT = [1, 2, 2, 3, 5, 5, 7, 7, 11, 11, 11, 11, 13, 13]


def _next_bkt(n: int) -> int:
    if n < len(_FAST_BKT):
        return _FAST_BKT[n]
    for p in _PRIMES:
        if p >= n:
            return p
    raise ValueError("too many elements")


class _Node:
    __slots__ = ("key", "val", "nxt")

    def __init__(self, key, val):
        self.key = key
        self.val = val
        self.nxt: Optional["_Node"] = None


class UnorderedMap:
    """insert-only unordered_map<integral, T> with libstdc++ node order"""

    def __init__(self, reserve: int = 0):
        self._head: Optional[_Node] = None
        self._n = 0
        self._nbkt = 1
        self._next_resize = 0
        if reserve > 0:  # reserve(n) = rehash(ceil(n / mlf))
            self._nbkt = _next_bkt(reserve)
            self._next_resize = self._nbkt
        self._bfirst = {}  # bucket -> its first node object

    def find(self, key):
        bkt = key % self._nbkt
        node = self._bfirst.get(bkt)
        while node is not None and (node.key % self._nbkt) == bkt:
            if node.key == key:
                return node
            node = node.nxt
        return None

    def _insert_node_begin(self, key, val):
        """_M_insert_bucket_begin: node becomes first of its bucket"""
        bkt = key % self._nbkt
        first = self._bfirst.get(bkt)
        node = _Node(key, val)
        if first is None:
            node.nxt = self._head
            self._head = node
            self._bfirst[bkt] = node
        else:
            # place new node at `first`'s list position via content swap
            node.key, node.val = first.key, first.val
            first.key, first.val = key, val
            node.nxt = first.nxt
            first.nxt = node
        self._n += 1

    def insert(self, key, val):
        node = self.find(key)
        if node is not None:
            node.val = val
            return node.val
        if self._n + 1 > self._next_resize:
            # _M_need_rehash: min_bkts seeded with 11 on the very first
            # insert (_M_next_resize==0), growth factor 2
            min_bkts = float(max(self._n + 1,
                                 11 if self._next_resize == 0 else 0))
            if min_bkts >= self._nbkt:
                self._rehash(_next_bkt(max(int(min_bkts) + 1, 2 * self._nbkt)))
            else:
                self._next_resize = self._nbkt
        self._insert_node_begin(key, val)
        return val

    def _rehash(self, nbkt: int):
        old = []
        node = self._head
        while node is not None:
            old.append((node.key, node.val))
            node = node.nxt
        self._nbkt = nbkt
        self._next_resize = nbkt  # floor(nbkt * 1.0)
        self._bfirst = {}
        self._head = None
        self._n = 0
        for (k, v) in old:  # _M_rehash_aux: list order, same primitive
            self._insert_node_begin(k, v)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        node = self._head
        while node is not None:
            yield node.key, node.val
            node = node.nxt

    def __len__(self):
        return self._n
