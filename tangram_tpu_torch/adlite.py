"""A lightweight, dependency-free AnnData-compatible container.

The reference framework (broadinstitute/Tangram) passes ``anndata.AnnData``
objects through its whole public API (see reference ``tangram/mapping_utils.py``
and ``tangram/utils.py``). This module provides a self-contained equivalent so
the PyTorch port has zero heavyweight single-cell dependencies: a dense/sparse
expression matrix ``X``, pandas ``obs``/``var`` frames, and the ``uns``,
``obsm``, ``varm``, ``obsp``, ``layers`` mappings, plus h5ad read/write built
directly on h5py. It is a copy of ``tangram_tpu/adlite.py`` (numpy, pandas
and h5py only), kept separate because importing any ``tangram_tpu`` module
imports jax.

Every public function in :mod:`tangram_tpu_torch` duck-types against this interface,
so a real ``anndata.AnnData`` (if the user has it installed) works unchanged —
the attribute surface is identical for the subset Tangram touches.
"""

from __future__ import annotations

import collections
from typing import Any, Mapping

import numpy as np
import pandas as pd
import scipy.sparse as sp

__all__ = ["AnnData", "read_h5ad", "write_h5ad", "filter_genes"]

#: sparse X and layer subsets taken by :meth:`AnnData.__getitem__`:
#: ``"columns"`` keeps every row and picks the columns alone, ``"rows"``
#: picks rows first (then columns)
SPARSE_SLICES = collections.Counter()


def _as_df(value, length: int, default_prefix: str) -> pd.DataFrame:
    if value is None:
        return pd.DataFrame(index=pd.Index([f"{default_prefix}{i}" for i in range(length)]))
    if isinstance(value, pd.DataFrame):
        df = value.copy()
        df.index = df.index.astype(str)
        return df
    if isinstance(value, Mapping):
        return pd.DataFrame(dict(value))
    raise TypeError(f"obs/var must be a DataFrame or mapping, got {type(value)}")


class AnnData:
    """Annotated data matrix: ``X`` is obs × vars (cells × genes or spots × genes)."""

    def __init__(
        self,
        X=None,
        obs=None,
        var=None,
        uns=None,
        obsm=None,
        varm=None,
        obsp=None,
        layers=None,
        dtype=None,
    ):
        if X is not None and not sp.issparse(X):
            X = np.asarray(X)
            if X.ndim == 1:
                X = X.reshape(1, -1)
        if dtype is not None and X is not None:
            X = X.astype(dtype)

        if X is not None:
            n_obs, n_vars = X.shape
        else:
            n_obs = len(obs) if obs is not None else 0
            n_vars = len(var) if var is not None else 0

        self._X = X
        self.obs = _as_df(obs, n_obs, "obs_")
        self.var = _as_df(var, n_vars, "var_")
        self.uns: dict[str, Any] = dict(uns) if uns else {}
        self.obsm: dict[str, Any] = dict(obsm) if obsm else {}
        self.varm: dict[str, Any] = dict(varm) if varm else {}
        self.obsp: dict[str, Any] = dict(obsp) if obsp else {}
        self.layers: dict[str, Any] = dict(layers) if layers else {}

        if X is not None:
            if len(self.obs) != n_obs:
                raise ValueError(f"obs length {len(self.obs)} != X rows {n_obs}")
            if len(self.var) != n_vars:
                raise ValueError(f"var length {len(self.var)} != X cols {n_vars}")

    # -- core attributes -------------------------------------------------
    @property
    def X(self):
        return self._X

    @X.setter
    def X(self, value):
        self._X = value

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    @property
    def n_vars(self) -> int:
        return len(self.var)

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, value):
        self.obs.index = pd.Index(value).astype(str)

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, value):
        self.var.index = pd.Index(value).astype(str)

    def __len__(self) -> int:
        return self.n_obs

    def __repr__(self) -> str:  # pragma: no cover
        parts = [f"AnnData object with n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for name in ("obs", "var"):
            cols = list(getattr(self, name).columns)
            if cols:
                parts.append(f"    {name}: {', '.join(map(repr, cols))}")
        for name in ("uns", "obsm", "varm", "obsp", "layers"):
            keys = list(getattr(self, name).keys())
            if keys:
                parts.append(f"    {name}: {', '.join(map(repr, keys))}")
        return "\n".join(parts)

    # -- indexing ---------------------------------------------------------
    def _resolve_obs_indexer(self, key) -> np.ndarray:
        if isinstance(key, slice):
            return np.arange(self.n_obs)[key]
        if isinstance(key, str):
            key = [key]
        if isinstance(key, pd.Series):
            key = key.to_numpy()
        key = np.atleast_1d(np.asarray(key))
        if key.dtype == bool:
            if key.shape[0] != self.n_obs:
                raise IndexError("boolean obs mask has wrong length")
            return np.where(key)[0]
        if key.dtype.kind in "iu":
            return key
        idx = self.obs.index.get_indexer(key.astype(str))
        if (idx < 0).any():
            missing = [o for o, i in zip(np.asarray(key), idx) if i < 0]
            raise KeyError(f"obs names not found: {missing[:5]}")
        return idx

    def _resolve_var_indexer(self, key) -> np.ndarray:
        if isinstance(key, slice):
            return np.arange(self.n_vars)[key]
        if isinstance(key, str):
            key = [key]
        if isinstance(key, pd.Series):
            key = key.to_numpy()
        key = np.atleast_1d(np.asarray(key))
        if key.dtype == bool:
            if key.shape[0] != self.n_vars:
                raise IndexError("boolean var mask has wrong length")
            return np.where(key)[0]
        if key.dtype.kind in "iu":
            return key
        idx = self.var.index.get_indexer(key.astype(str))
        if (idx < 0).any():
            missing = [g for g, i in zip(np.asarray(key), idx) if i < 0]
            raise KeyError(f"var names not found: {missing[:5]}")
        return idx

    def __getitem__(self, key) -> "AnnData":
        if isinstance(key, tuple):
            obs_key, var_key = key
        else:
            obs_key, var_key = key, slice(None)
        # identity fast paths: adata[:, genes] must not reindex (and copy)
        # O(spots²) obsp graphs nor copy a sparse X's rows before picking its
        # genes, and adata[cells] must not copy layers' genes
        obs_all = isinstance(obs_key, slice) and obs_key == slice(None)
        var_all = isinstance(var_key, slice) and var_key == slice(None)
        oi = self._resolve_obs_indexer(obs_key)
        vi = self._resolve_var_indexer(var_key)

        def rows(v, idx, identity):
            return v if identity else _index_rows(v, idx)

        def square(v):
            if obs_all:
                return v
            return v[oi][:, oi] if sp.issparse(v) else np.asarray(v)[np.ix_(oi, oi)]

        def grid(v):
            if obs_all and var_all:
                return v
            if sp.issparse(v):
                if obs_all:
                    SPARSE_SLICES["columns"] += 1
                    return v[:, vi]
                SPARSE_SLICES["rows"] += 1
                return v[oi][:, vi]
            v = np.asarray(v)
            return v[np.ix_(oi, vi)] if (oi.ndim and vi.ndim) else v[oi][:, vi]

        X = self._X
        if X is not None:
            X = grid(X)
        sub = AnnData(
            X=X,
            obs=self.obs if obs_all else self.obs.iloc[oi],
            var=self.var if var_all else self.var.iloc[vi],
            uns=self.uns,
            obsm={k: rows(v, oi, obs_all) for k, v in self.obsm.items()},
            varm={k: rows(v, vi, var_all) for k, v in self.varm.items()},
            obsp={k: square(v) for k, v in self.obsp.items()},
            layers={k: grid(v) for k, v in self.layers.items()},
        )
        return sub

    # -- utilities ---------------------------------------------------------
    def copy(self) -> "AnnData":
        X = self._X
        if X is not None:
            X = X.copy()
        return AnnData(
            X=X,
            obs=self.obs.copy(),
            var=self.var.copy(),
            uns={k: _copy_val(v) for k, v in self.uns.items()},
            obsm={k: _copy_val(v) for k, v in self.obsm.items()},
            varm={k: _copy_val(v) for k, v in self.varm.items()},
            obsp={k: _copy_val(v) for k, v in self.obsp.items()},
            layers={k: _copy_val(v) for k, v in self.layers.items()},
        )

    def var_names_make_unique(self, join: str = "-") -> None:
        self.var.index = _make_unique(self.var.index, join)

    def obs_names_make_unique(self, join: str = "-") -> None:
        self.obs.index = _make_unique(self.obs.index, join)

    def toarray(self):
        X = self._X
        return X.toarray() if sp.issparse(X) else np.asarray(X)

    def write_h5ad(self, filename, compression=None) -> None:
        write_h5ad(filename, self, compression=compression)

    write = write_h5ad


def _index_rows(v, idx):
    if isinstance(v, pd.DataFrame):
        return v.iloc[idx]
    if isinstance(v, pd.Series):
        return v.iloc[idx]
    if sp.issparse(v):
        return v[idx]
    return np.asarray(v)[idx]


def _copy_val(v):
    if isinstance(v, (pd.DataFrame, pd.Series)):
        return v.copy()
    if sp.issparse(v):
        return v.copy()
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, dict):
        return {k: _copy_val(x) for k, x in v.items()}
    return v


def _make_unique(index: pd.Index, join: str = "-") -> pd.Index:
    values = index.astype(str).to_numpy().copy()
    counts: dict[str, int] = {}
    existing = set(values)
    for i, v in enumerate(values):
        if v in counts:
            n = counts[v]
            new = f"{v}{join}{n}"
            while new in existing:
                n += 1
                new = f"{v}{join}{n}"
            counts[v] = n + 1
            values[i] = new
            existing.add(new)
        else:
            counts[v] = 1
    return pd.Index(values)


def filter_genes(adata: AnnData, min_cells: int = 1) -> None:
    """In-place removal of genes expressed in fewer than ``min_cells`` cells.

    Mirrors the behavior of ``scanpy.pp.filter_genes`` as used by the reference
    preprocessing (reference ``tangram/mapping_utils.py:39-40``): also writes
    ``var['n_cells']``.
    """
    X = adata.X
    if X is None:
        return
    if sp.issparse(X):
        n_cells = np.asarray((X != 0).sum(axis=0)).ravel()
    else:
        n_cells = (np.asarray(X) != 0).sum(axis=0)
    keep = n_cells >= min_cells
    adata.var["n_cells"] = n_cells
    if not keep.all():
        kept = np.where(keep)[0]
        if type(adata).__module__.split(".")[0] == "anndata":
            # Real anndata.AnnData rejects shape-changing X/var assignment;
            # its own in-place subsetting keeps every aligned field coherent.
            adata._inplace_subset_var(keep)
            return
        adata.X = X[:, kept] if sp.issparse(X) else np.asarray(X)[:, kept]
        adata.var = adata.var.iloc[kept]
        for k in list(adata.varm):
            adata.varm[k] = _index_rows(adata.varm[k], kept)
        for k in list(adata.layers):
            v = adata.layers[k]
            adata.layers[k] = v[:, kept] if sp.issparse(v) else np.asarray(v)[:, kept]


# ---------------------------------------------------------------------------
# h5ad IO (anndata >=0.8 on-disk encoding, with tolerant fallbacks)
# ---------------------------------------------------------------------------

def _h5py():
    import h5py

    return h5py


def read_h5ad(filename) -> AnnData:
    """Read an ``.h5ad`` file written by anndata (>=0.7 encodings) or by us."""
    h5py = _h5py()
    with h5py.File(filename, "r") as f:
        X = _read_elem(f["X"]) if "X" in f else None
        obs = _read_elem(f["obs"]) if "obs" in f else None
        var = _read_elem(f["var"]) if "var" in f else None
        uns = _read_elem(f["uns"]) if "uns" in f else {}
        obsm = _read_elem(f["obsm"]) if "obsm" in f else {}
        varm = _read_elem(f["varm"]) if "varm" in f else {}
        obsp = _read_elem(f["obsp"]) if "obsp" in f else {}
        layers = _read_elem(f["layers"]) if "layers" in f else {}
    return AnnData(X=X, obs=obs, var=var, uns=uns, obsm=obsm, varm=varm, obsp=obsp, layers=layers)


def _decode(v):
    if isinstance(v, bytes):
        return v.decode()
    return v


def _read_elem(elem):
    h5py = _h5py()
    enc = _decode(elem.attrs.get("encoding-type", ""))

    if isinstance(elem, h5py.Dataset):
        value = elem[()]
        if enc == "string" or isinstance(value, bytes):
            return _decode(value)
        if enc == "string-array" or (hasattr(value, "dtype") and value.dtype.kind in "OS"):
            return np.array([_decode(x) for x in np.asarray(value).ravel()]).reshape(np.asarray(value).shape)
        return value

    # groups
    if enc in ("csr_matrix", "csc_matrix") or ("indptr" in elem and "data" in elem):
        data = elem["data"][()]
        indices = elem["indices"][()]
        indptr = elem["indptr"][()]
        shape = tuple(elem.attrs.get("shape", elem.attrs.get("h5sparse_shape")))
        fmt = enc or _decode(elem.attrs.get("h5sparse_format", "csr")) + "_matrix"
        cls = sp.csr_matrix if fmt.startswith("csr") else sp.csc_matrix
        return cls((data, indices, indptr), shape=shape)

    if enc == "categorical" or ("categories" in elem and "codes" in elem):
        categories = _read_elem(elem["categories"])
        codes = elem["codes"][()]
        return pd.Categorical.from_codes(codes, categories=[_decode(c) for c in np.asarray(categories)])

    if enc in ("nullable-integer", "nullable-boolean") or (
        "values" in elem and "mask" in elem
    ):
        values = np.asarray(elem["values"][()])
        mask = np.asarray(elem["mask"][()]).astype(bool)
        if enc == "nullable-boolean":
            return pd.arrays.BooleanArray(values.astype(bool), mask)
        return pd.arrays.IntegerArray(values.astype(np.int64), mask)

    if enc == "dataframe" or "_index" in elem.attrs:
        index_key = _decode(elem.attrs.get("_index", "_index"))
        order = [_decode(c) for c in elem.attrs.get("column-order", [])]
        cols = {}
        for key in elem:
            if key == index_key:
                continue
            cols[key] = _read_elem(elem[key])
        index = _read_elem(elem[index_key]) if index_key in elem else None
        ordered = [c for c in order if c in cols] + [c for c in cols if c not in order]
        df = pd.DataFrame({c: cols[c] for c in ordered})
        if index is not None:
            df.index = pd.Index([_decode(x) for x in np.asarray(index)])
        return df

    # plain dict-like group
    out = {}
    for key in elem:
        out[key] = _read_elem(elem[key])
    return out


def write_h5ad(filename, adata: AnnData, compression=None) -> None:
    h5py = _h5py()
    with h5py.File(filename, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        if adata.X is not None:
            _write_elem(f, "X", adata.X, compression)
        _write_elem(f, "obs", adata.obs, compression)
        _write_elem(f, "var", adata.var, compression)
        _write_elem(f, "uns", adata.uns, compression)
        _write_elem(f, "obsm", dict(adata.obsm), compression)
        _write_elem(f, "varm", dict(adata.varm), compression)
        _write_elem(f, "obsp", dict(adata.obsp), compression)
        _write_elem(f, "layers", dict(adata.layers), compression)


def _write_elem(group, key, value, compression=None):
    h5py = _h5py()
    str_dtype = h5py.string_dtype(encoding="utf-8")

    if sp.issparse(value):
        value = value.tocsr() if not sp.isspmatrix_csc(value) else value
        g = group.create_group(key)
        g.attrs["encoding-type"] = "csc_matrix" if sp.isspmatrix_csc(value) else "csr_matrix"
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.asarray(value.shape, dtype=np.int64)
        g.create_dataset("data", data=value.data, compression=compression)
        g.create_dataset("indices", data=value.indices, compression=compression)
        g.create_dataset("indptr", data=value.indptr, compression=compression)
        return

    if isinstance(value, pd.DataFrame):
        g = group.create_group(key)
        g.attrs["encoding-type"] = "dataframe"
        g.attrs["encoding-version"] = "0.2.0"
        g.attrs["_index"] = "_index"
        g.attrs["column-order"] = np.asarray(list(value.columns), dtype=str_dtype)
        _write_elem(g, "_index", value.index.astype(str).to_numpy(), compression)
        for col in value.columns:
            _write_elem(g, str(col), value[col], compression)
        return

    if isinstance(value, pd.Series):
        if isinstance(value.dtype, pd.CategoricalDtype):
            value = value.values
        else:
            value = value.to_numpy()

    if isinstance(value, pd.Categorical):
        g = group.create_group(key)
        g.attrs["encoding-type"] = "categorical"
        g.attrs["encoding-version"] = "0.2.0"
        g.attrs["ordered"] = bool(value.ordered)
        _write_elem(g, "categories", np.asarray(value.categories), compression)
        g.create_dataset("codes", data=value.codes, compression=compression)
        return

    if isinstance(value, Mapping):
        g = group.create_group(key)
        g.attrs["encoding-type"] = "dict"
        g.attrs["encoding-version"] = "0.1.0"
        for k, v in value.items():
            _write_elem(g, str(k), v, compression)
        return

    if isinstance(value, str):
        ds = group.create_dataset(key, data=value, dtype=str_dtype)
        ds.attrs["encoding-type"] = "string"
        ds.attrs["encoding-version"] = "0.2.0"
        return

    if isinstance(value, (list, tuple)):
        value = np.asarray(value)

    if isinstance(value, np.ndarray) and value.dtype.kind in "OUS":
        ds = group.create_dataset(
            key, data=np.asarray(value, dtype=object), dtype=str_dtype
        )
        ds.attrs["encoding-type"] = "string-array"
        ds.attrs["encoding-version"] = "0.2.0"
        return

    if isinstance(value, np.ndarray):
        if value.dtype == bool:
            value = value.astype("uint8")
        ds = group.create_dataset(key, data=value, compression=compression)
        ds.attrs["encoding-type"] = "array"
        ds.attrs["encoding-version"] = "0.2.0"
        return

    if isinstance(value, (bool, np.bool_)):
        ds = group.create_dataset(key, data=np.uint8(value))
        ds.attrs["encoding-type"] = "numeric-scalar"
        ds.attrs["encoding-version"] = "0.2.0"
        return

    if isinstance(value, (int, float, np.integer, np.floating)):
        ds = group.create_dataset(key, data=value)
        ds.attrs["encoding-type"] = "numeric-scalar"
        ds.attrs["encoding-version"] = "0.2.0"
        return

    if value is None:
        return

    raise TypeError(f"Cannot write value of type {type(value)} at key {key!r}")
