"""Nexmark event generator source — the benchmark workhorse.

Port of ``risingwave_tpu/connectors/nexmark.py``: the numpy generator is
copied unchanged (the same config and seed give the same events as the
reference); only ``next_chunks`` differs, building torch chunks on a
given device.

Reference: src/connector/src/source/nexmark/source/reader.rs:42 (the
SplitReader wrapping the `nexmark` crate's EventGenerator) and the
public Nexmark generator semantics that crate implements:

- events cycle deterministically 1 person : 3 auctions : 46 bids per
  50-event epoch;
- person/auction ids chain off the event number (last_base0_* formulas)
  so every bid references an auction/person that has already been
  generated — this is what makes q8-style stream joins meaningful;
- hot-key skew: most bids target the most recent "hot" auctions /
  bidders (1/hot_ratio of ids), matching real auction traffic;
- event timestamps advance at a configured inter-event gap, giving a
  controllable events/sec rate.

Design: generation is fully vectorized numpy (no per-event
objects); a batch of N event indices becomes three compacted column
sets (persons / auctions / bids) handed to the pipeline as fixed-
capacity StreamChunks. Splits partition the event-index space round-
robin exactly like the reference's split_index/split_num
(reader.rs:78-84), so multi-split generation is reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from risingwave_tpu_torch.array.chunk import StreamChunk
from risingwave_tpu_torch.array.dictionary import StringDictionary
from risingwave_tpu_torch.types import DataType, Schema

# proportions fixed by the Nexmark spec
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
PROPORTION_DENOMINATOR = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10

PERSON_SCHEMA = Schema(
    [
        ("id", DataType.INT64),
        ("name", DataType.VARCHAR),
        ("city", DataType.VARCHAR),
        ("state", DataType.VARCHAR),
        ("date_time", DataType.TIMESTAMP),
    ]
)

AUCTION_SCHEMA = Schema(
    [
        ("id", DataType.INT64),
        ("item_name", DataType.VARCHAR),
        ("initial_bid", DataType.INT64),
        ("reserve", DataType.INT64),
        ("date_time", DataType.TIMESTAMP),
        ("expires", DataType.TIMESTAMP),
        ("seller", DataType.INT64),
        ("category", DataType.INT64),
    ]
)

BID_SCHEMA = Schema(
    [
        ("auction", DataType.INT64),
        ("bidder", DataType.INT64),
        ("price", DataType.INT64),
        ("channel", DataType.VARCHAR),
        ("date_time", DataType.TIMESTAMP),
    ]
)

_CHANNELS = ["Google", "Facebook", "Baidu", "Apple"]
_CITIES = ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland",
           "Bend", "Redmond", "Seattle", "Kent", "Cheyenne"]
_STATES = ["AZ", "CA", "ID", "OR", "WA", "WY"]
_FIRST = ["Peter", "Paul", "Luke", "John", "Saul", "Vicky", "Kate", "Julie",
          "Sarah", "Deiter", "Walter"]
_LAST = ["Shultz", "Abrams", "Spencer", "White", "Bartels", "Walton", "Smith",
         "Jones", "Noris"]


@dataclass
class NexmarkConfig:
    """Generator knobs (subset of the crate's NexmarkConfig that the
    benchmark queries exercise; defaults mirror the spec)."""

    first_event_rate: int = 10_000  # events/sec
    base_time_ms: int = 1_436_918_400_000  # spec BASE_TIME
    hot_auction_ratio: int = 2
    hot_bidder_ratio: int = 4
    hot_seller_ratio: int = 4
    num_active_people: int = 1000
    num_in_flight_auctions: int = 100
    auction_duration_ms: int = 10_000


_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the counter-based RNG core: randomness is
    a PURE function of (seed, split, event ordinal, use-site), so the
    stream is identical no matter how generation is batched (offset
    resume replays exactly; code-review r2 finding #6)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


def _last_base0_person_id(event_id: np.ndarray) -> np.ndarray:
    epoch = event_id // PROPORTION_DENOMINATOR
    offset = event_id % PROPORTION_DENOMINATOR
    offset = np.minimum(offset, PERSON_PROPORTION - 1)
    return epoch * PERSON_PROPORTION + offset


def _last_base0_auction_id(event_id: np.ndarray) -> np.ndarray:
    epoch = event_id // PROPORTION_DENOMINATOR
    offset = event_id % PROPORTION_DENOMINATOR
    before = offset < PERSON_PROPORTION
    epoch = np.where(before, epoch - 1, epoch)
    offset = np.where(
        before,
        AUCTION_PROPORTION - 1,
        np.where(
            offset >= PERSON_PROPORTION + AUCTION_PROPORTION,
            AUCTION_PROPORTION - 1,
            offset - PERSON_PROPORTION,
        ),
    )
    return epoch * AUCTION_PROPORTION + offset


class NexmarkGenerator:
    """Deterministic, seedable, vectorized event generator for one split."""

    def __init__(
        self,
        config: Optional[NexmarkConfig] = None,
        split_index: int = 0,
        split_num: int = 1,
        seed: int = 42,
        dictionaries: Optional[Dict[str, StringDictionary]] = None,
    ):
        self.config = config if config is not None else NexmarkConfig()
        self.split_index = split_index
        self.split_num = split_num
        self.seed = seed
        self._next_ordinal = 0  # ordinal within this split
        # VARCHAR codes are only equality-complete if every split shares
        # ONE dictionary set; private per-split dictionaries would assign
        # diverging codes to the same string and silently break
        # cross-split group-by/join. Build them via make_dictionaries()
        # and pass to every split.
        if dictionaries is None and split_num > 1:
            raise ValueError(
                "multi-split generation requires a shared `dictionaries` "
                "set (use NexmarkGenerator.make_dictionaries())"
            )
        self.dicts = (
            dictionaries if dictionaries is not None else self.make_dictionaries()
        )
        # pre-encode the small vocabularies so codes are dense & stable
        self._city_codes = self.dicts["city"].encode(_CITIES)
        self._state_codes = self.dicts["state"].encode(_STATES)
        self._chan_codes = self.dicts["channel"].encode(_CHANNELS)
        self._name_codes = self.dicts["name"].encode(
            [f"{f} {l}" for f in _FIRST for l in _LAST]
        )
        self._item_codes = self.dicts["item_name"].encode(
            [f"item-{c}" for c in range(997)]
        )

    def _h(self, eid: np.ndarray, site: int) -> np.ndarray:
        """64 random bits per EVENT for one use site."""
        seed_mix = (self.seed * 0xC2B2AE3D27D4EB4F) & 0xFFFFFFFFFFFFFFFF
        salt = (seed_mix ^ (site << 32)) & 0xFFFFFFFFFFFFFFFF
        x = eid.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return _mix64(x ^ np.uint64(salt))

    def _randbelow(self, eid: np.ndarray, site: int, n) -> np.ndarray:
        return (self._h(eid, site) % np.asarray(n).astype(np.uint64)).astype(
            np.int64
        )

    def _u01(self, eid: np.ndarray, site: int) -> np.ndarray:
        return (self._h(eid, site) >> np.uint64(11)) * (2.0 ** -53)

    @staticmethod
    def make_dictionaries() -> Dict[str, StringDictionary]:
        return {
            "name": StringDictionary(),
            "city": StringDictionary(),
            "state": StringDictionary(),
            "item_name": StringDictionary(),
            "channel": StringDictionary(),
        }

    # -- core ------------------------------------------------------------
    def next_events(self, count: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Generate the next ``count`` events of this split, compacted
        into three column dicts: {"person": {...}, "auction": {...},
        "bid": {...}} (any may be empty)."""
        cfg = self.config
        ordinals = self._next_ordinal + np.arange(count, dtype=np.int64)
        self._next_ordinal += count
        # round-robin split partition of the global event-index space
        event_ids = ordinals * self.split_num + self.split_index
        rem = event_ids % PROPORTION_DENOMINATOR
        # ms timestamps advancing at the configured rate
        ts = cfg.base_time_ms + (event_ids * 1000) // cfg.first_event_rate

        is_person = rem < PERSON_PROPORTION
        is_auction = (~is_person) & (rem < PERSON_PROPORTION + AUCTION_PROPORTION)
        is_bid = ~is_person & ~is_auction

        out = {
            "person": self._persons(event_ids[is_person], ts[is_person]),
            "auction": self._auctions(event_ids[is_auction], ts[is_auction]),
            "bid": self._bids(event_ids[is_bid], ts[is_bid]),
        }
        return out

    def _persons(self, eid: np.ndarray, ts: np.ndarray):
        n = len(eid)
        pid = _last_base0_person_id(eid) + FIRST_PERSON_ID
        return {
            "id": pid,
            "name": self._name_codes[
                self._randbelow(eid, 1, len(self._name_codes))
            ].astype(np.int32),
            "city": self._city_codes[
                self._randbelow(eid, 2, len(self._city_codes))
            ].astype(np.int32),
            "state": self._state_codes[
                self._randbelow(eid, 3, len(self._state_codes))
            ].astype(np.int32),
            "date_time": ts,
        }

    def _auctions(self, eid: np.ndarray, ts: np.ndarray):
        n = len(eid)
        cfg = self.config
        aid = _last_base0_auction_id(eid) + FIRST_AUCTION_ID
        # seller: mostly the most recent "hot" person, else a recent one
        last_p = _last_base0_person_id(eid)
        hot = self._randbelow(eid, 4, cfg.hot_seller_ratio) > 0
        hot_seller = (last_p // cfg.hot_seller_ratio) * cfg.hot_seller_ratio
        active = np.minimum(last_p + 1, cfg.num_active_people)
        cold_seller = last_p - self._randbelow(eid, 5, np.maximum(active, 1))
        seller = np.where(hot, hot_seller, cold_seller) + FIRST_PERSON_ID
        initial = self._price(eid, 6)
        item = self._item_codes[aid % 997]
        return {
            "id": aid,
            "item_name": item.astype(np.int32),
            "initial_bid": initial,
            "reserve": initial + self._price(eid, 7) // 10,
            "date_time": ts,
            "expires": ts + cfg.auction_duration_ms,
            "seller": seller,
            "category": FIRST_CATEGORY_ID + self._randbelow(eid, 8, 5),
        }

    def _bids(self, eid: np.ndarray, ts: np.ndarray):
        n = len(eid)
        cfg = self.config
        last_a = _last_base0_auction_id(eid)
        hot_a = self._randbelow(eid, 9, cfg.hot_auction_ratio) > 0
        hot_auction = (last_a // cfg.hot_auction_ratio) * cfg.hot_auction_ratio
        in_flight = np.maximum(np.minimum(last_a + 1, cfg.num_in_flight_auctions), 1)
        cold_auction = last_a - self._randbelow(eid, 10, in_flight)
        auction = np.where(hot_a, hot_auction, cold_auction) + FIRST_AUCTION_ID

        last_p = _last_base0_person_id(eid)
        hot_b = self._randbelow(eid, 11, cfg.hot_bidder_ratio) > 0
        hot_bidder = (last_p // cfg.hot_bidder_ratio) * cfg.hot_bidder_ratio + 1
        active = np.maximum(np.minimum(last_p + 1, cfg.num_active_people), 1)
        cold_bidder = last_p - self._randbelow(eid, 12, active)
        bidder = np.where(hot_b, hot_bidder, cold_bidder) + FIRST_PERSON_ID

        return {
            "auction": auction,
            "bidder": bidder,
            "price": self._price(eid, 13),
            "channel": self._chan_codes[
                self._randbelow(eid, 14, len(self._chan_codes))
            ].astype(np.int32),
            "date_time": ts,
        }

    def _price(self, eid: np.ndarray, site: int) -> np.ndarray:
        """Spec price distribution: round(10^(U[0,1)*6) * 100) cents."""
        return np.round(
            np.power(10.0, self._u01(eid, site) * 6.0) * 100.0
        ).astype(np.int64)

    # -- chunk-producing source edge ------------------------------------
    # -- seekable-split offset API (reader.rs:42 offset semantics) ------
    @property
    def offset(self) -> int:
        return self._next_ordinal

    def seek(self, offset: int) -> None:
        self._next_ordinal = int(offset)

    def next_chunks(
        self, count: int, capacity: int, device="cuda"
    ) -> Dict[str, Optional[StreamChunk]]:
        """Generate ``count`` events as per-stream fixed-capacity
        StreamChunks on ``device`` (None where the batch produced no
        such events).

        ``capacity`` must cover the worst-case per-type yield:
        ceil(count * 46/50) for bids.
        """
        events = self.next_events(count)
        out = {}
        for stream, schema in (
            ("person", PERSON_SCHEMA),
            ("auction", AUCTION_SCHEMA),
            ("bid", BID_SCHEMA),
        ):
            cols = events[stream]
            n = len(next(iter(cols.values()))) if cols else 0
            if n == 0:
                out[stream] = None
                continue
            out[stream] = StreamChunk.from_numpy(
                cols, capacity, schema=schema, device=device
            )
        return out
