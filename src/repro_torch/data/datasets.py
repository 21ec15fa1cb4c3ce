"""Synthetic dataset generators shaped to the paper's Table 1.

| dataset     | tables | inputs (num/cat) | features after encoding |
|-------------|--------|------------------|--------------------------|
| Credit Card | 1      | 28 (28/0)        | 28                       |
| Hospital    | 1      | 24 (9/15)        | 59  (9 num + 50 binary)  |
| Expedia     | 3      | 28 (8/20)        | 3965 (8 + 3957)          |
| Flights     | 4      | 37 (4/33)        | 6475 (4 + 6471)          |

Real datasets are unavailable offline, so each generator plants a ground-truth
decision structure (a random sparse logit over scaled numerics + a few
categorical indicator effects) so trained models learn non-trivial,
*partially-sparse* functions — reproducing the paper's observation that a
large fraction of features go unused at inference time.

Multi-table datasets return a fact table plus dimension tables with integer
join keys, so prediction queries exercise 3-way / 4-way joins.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Dataset:
    name: str
    tables: dict[str, dict[str, np.ndarray]]  # table -> column -> values
    fact: str  # fact-table name
    join_keys: list[tuple[str, str, str]]  # (fact_col, dim_table, dim_col)
    numeric: list[str]  # model input columns (on the joined view)
    categorical: list[str]
    label: np.ndarray
    _card: dict[str, int] = field(default_factory=dict)  # declared cardinalities

    def joined_columns(self) -> dict[str, np.ndarray]:
        """Materialize the joined view (oracle for testing the engine)."""
        out = dict(self.tables[self.fact])
        for fact_col, dim_table, dim_col in self.join_keys:
            keys = out[fact_col]
            dim = self.tables[dim_table]
            order = np.argsort(dim[dim_col])
            pos = order[np.searchsorted(dim[dim_col], keys, sorter=order)]
            for c, v in dim.items():
                if c != dim_col:
                    out[c] = v[pos]
        return out

    def n_rows(self) -> int:
        return len(self.label)

    def categories(self) -> dict[str, np.ndarray]:
        """Declared category domains (full cardinality, independent of sample
        size) so encoded feature widths match the paper's Table 1."""
        joined = self.joined_columns()
        return {
            c: np.arange(int(self._card[c])) if c in self._card
            else np.unique(joined[c])
            for c in self.categorical
        }


def _planted_label(
    rng: np.random.Generator,
    num_cols: dict[str, np.ndarray],
    cat_cols: dict[str, np.ndarray],
    sparsity: float = 0.5,
) -> np.ndarray:
    """Sparse planted logit: only ~(1-sparsity) of inputs matter."""
    n = len(next(iter({**num_cols, **cat_cols}.values())))
    z = np.zeros(n)
    for v in num_cols.values():
        if rng.random() > sparsity:
            w = rng.normal(0, 1.5)
            z += w * (v - v.mean()) / (v.std() + 1e-9)
    for v in cat_cols.values():
        if rng.random() > sparsity:
            hot = rng.integers(0, max(1, v.max() + 1))
            z += rng.normal(0, 2.0) * (v == hot)
    z += rng.normal(0, 0.25, size=n)  # noise
    p = 1 / (1 + np.exp(-(z - np.median(z))))
    return (rng.random(n) < p).astype(np.int64)


def make_credit_card(n: int = 4096, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    cols = {f"v{i}": rng.normal(0, 1 + i * 0.05, n) for i in range(28)}
    label = _planted_label(rng, cols, {}, sparsity=0.6)
    return Dataset(
        name="credit_card",
        tables={"transactions": cols},
        fact="transactions",
        join_keys=[],
        numeric=list(cols),
        categorical=[],
        label=label,
    )


def make_hospital(n: int = 4096, seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    numeric_names = [
        "age", "bmi", "pulse", "bpm", "respiration",
        "glucose", "sodium", "creatinine", "hematocrit",
    ]
    num = {
        "age": rng.integers(18, 95, n).astype(np.float64),
        "bmi": rng.normal(27, 5, n),
        "pulse": rng.normal(75, 12, n),
        "bpm": rng.normal(120, 18, n),
        "respiration": rng.normal(16, 3, n),
        "glucose": rng.normal(105, 25, n),
        "sodium": rng.normal(139, 4, n),
        "creatinine": rng.normal(1.1, 0.4, n),
        "hematocrit": rng.normal(42, 5, n),
    }
    # 15 categorical columns; cardinalities sum so one-hot width = 50
    cat_cards = [2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 4, 6, 7, 9]
    assert sum(cat_cards) == 50
    cat_names = [
        "asthma", "diabetes", "smoker", "hypertension", "copd",
        "dialysis", "stroke", "obesity", "depression", "gender3",
        "admission_type", "blood_type", "rcount", "ward", "num_issues",
    ]
    cat = {
        name: rng.integers(0, card, n)
        for name, card in zip(cat_names, cat_cards)
    }
    label = _planted_label(rng, num, cat, sparsity=0.45)
    return Dataset(
        name="hospital",
        tables={"patients": {**num, **cat}},
        fact="patients",
        join_keys=[],
        numeric=numeric_names,
        categorical=cat_names,
        label=label,
        _card={n: c for n, c in zip(cat_names, cat_cards)},
    )


def _split_cards(total: int, k: int, rng) -> list[int]:
    """k positive ints summing to total, heavy-tailed like real cat columns."""
    w = rng.pareto(1.5, k) + 1.0
    c = np.maximum(2, np.round(w / w.sum() * total).astype(int))
    while c.sum() != total:
        i = rng.integers(0, k)
        if c.sum() > total and c[i] > 2:
            c[i] -= 1
        elif c.sum() < total:
            c[i] += 1
    return list(c)


def make_expedia(n: int = 4096, seed: int = 2) -> Dataset:
    """3 tables: searches (fact) ⋈ hotels ⋈ destinations. 8 num / 20 cat,
    3957 one-hot columns."""
    rng = np.random.default_rng(seed)
    n_hotel, n_dest = max(16, n // 64), max(8, n // 128)
    cards = _split_cards(3957, 20, rng)
    # distribute cat columns: 8 on fact, 6 on hotels, 6 on destinations
    fact_num = {f"s_num{i}": rng.normal(0, 1, n) for i in range(4)}
    fact_cat = {
        f"s_cat{i}": rng.integers(0, cards[i], n) for i in range(8)
    }
    hotel_num = {f"h_num{i}": rng.normal(0, 1, n_hotel) for i in range(2)}
    hotel_cat = {
        f"h_cat{i}": rng.integers(0, cards[8 + i], n_hotel) for i in range(6)
    }
    dest_num = {f"d_num{i}": rng.normal(0, 1, n_dest) for i in range(2)}
    dest_cat = {
        f"d_cat{i}": rng.integers(0, cards[14 + i], n_dest) for i in range(6)
    }
    fact = {
        **fact_num,
        **fact_cat,
        "hotel_id": rng.integers(0, n_hotel, n),
        "dest_id": rng.integers(0, n_dest, n),
    }
    hotels = {"hotel_id": np.arange(n_hotel), **hotel_num, **hotel_cat}
    dests = {"dest_id": np.arange(n_dest), **dest_num, **dest_cat}
    ds = Dataset(
        name="expedia",
        tables={"searches": fact, "hotels": hotels, "destinations": dests},
        fact="searches",
        join_keys=[("hotel_id", "hotels", "hotel_id"), ("dest_id", "destinations", "dest_id")],
        numeric=list(fact_num) + list(hotel_num) + list(dest_num),
        categorical=list(fact_cat) + list(hotel_cat) + list(dest_cat),
        label=np.zeros(n, dtype=np.int64),
        _card={
            **{f"s_cat{i}": cards[i] for i in range(8)},
            **{f"h_cat{i}": cards[8 + i] for i in range(6)},
            **{f"d_cat{i}": cards[14 + i] for i in range(6)},
        },
    )
    joined = ds.joined_columns()
    ds.label = _planted_label(
        rng,
        {c: joined[c] for c in ds.numeric},
        {c: joined[c] for c in ds.categorical[:6]},
        sparsity=0.5,
    )
    return ds


def make_flights(n: int = 4096, seed: int = 3) -> Dataset:
    """4 tables: flights ⋈ airlines ⋈ src_airport ⋈ dst_airport.
    4 num / 33 cat, 6471 one-hot columns."""
    rng = np.random.default_rng(seed)
    n_air, n_ap = max(8, n // 256), max(16, n // 64)
    cards = _split_cards(6471, 33, rng)
    fact_num = {"dep_delay": rng.normal(5, 20, n), "distance": rng.normal(900, 500, n)}
    fact_cat = {f"f_cat{i}": rng.integers(0, cards[i], n) for i in range(13)}
    airline_num = {"fleet_age": rng.normal(10, 4, n_air)}
    airline_cat = {f"a_cat{i}": rng.integers(0, cards[13 + i], n_air) for i in range(6)}
    src_num = {"src_elev": rng.normal(300, 200, n_ap)}
    src_cat = {f"s_cat{i}": rng.integers(0, cards[19 + i], n_ap) for i in range(7)}
    dst_cat = {f"d_cat{i}": rng.integers(0, cards[26 + i], n_ap) for i in range(7)}
    fact = {
        **fact_num,
        **fact_cat,
        "airline_id": rng.integers(0, n_air, n),
        "src_id": rng.integers(0, n_ap, n),
        "dst_id": rng.integers(0, n_ap, n),
    }
    airlines = {"airline_id": np.arange(n_air), **airline_num, **airline_cat}
    srcs = {"src_id": np.arange(n_ap), **src_num, **src_cat}
    dsts = {"dst_id": np.arange(n_ap), **dst_cat}
    ds = Dataset(
        name="flights",
        tables={"flights": fact, "airlines": airlines, "src_airports": srcs, "dst_airports": dsts},
        fact="flights",
        join_keys=[
            ("airline_id", "airlines", "airline_id"),
            ("src_id", "src_airports", "src_id"),
            ("dst_id", "dst_airports", "dst_id"),
        ],
        numeric=list(fact_num) + list(airline_num) + list(src_num),
        categorical=list(fact_cat) + list(airline_cat) + list(src_cat) + list(dst_cat),
        label=np.zeros(n, dtype=np.int64),
        _card={
            **{f"f_cat{i}": cards[i] for i in range(13)},
            **{f"a_cat{i}": cards[13 + i] for i in range(6)},
            **{f"s_cat{i}": cards[19 + i] for i in range(7)},
            **{f"d_cat{i}": cards[26 + i] for i in range(7)},
        },
    )
    joined = ds.joined_columns()
    ds.label = _planted_label(
        rng,
        {c: joined[c] for c in ds.numeric},
        {c: joined[c] for c in ds.categorical[:5]},
        sparsity=0.5,
    )
    return ds


DATASETS = {
    "credit_card": make_credit_card,
    "hospital": make_hospital,
    "expedia": make_expedia,
    "flights": make_flights,
}
