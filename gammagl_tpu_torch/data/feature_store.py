"""FeatureStore: an addressable feature backend (counterpart of
`gammagl_tpu/data/feature_store.py`; reference
gammagl/data/feature_store.py:51,98,261): `TensorAttr` addresses a
(group, attribute, index), and put / get / remove / multi_get work on
those addresses. `InMemoryFeatureStore` keeps numpy arrays on the host;
a loader moves the rows it gathers to the card."""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gammagl_tpu_torch.data.graph import _host

__all__ = ["TensorAttr", "FeatureStore", "InMemoryFeatureStore"]


@dataclasses.dataclass
class TensorAttr:
    """Address of a tensor in the store (reference feature_store.py:51)."""

    group_name: Optional[str] = None
    attr_name: Optional[str] = None
    index: Optional[Any] = None

    def is_fully_specified(self):
        return self.group_name is not None and self.attr_name is not None

    def update(self, other: "TensorAttr"):
        for f in dataclasses.fields(self):
            v = getattr(other, f.name)
            if v is not None:
                setattr(self, f.name, v)
        return self


class FeatureStore:
    """Abstract key-value feature backend (reference feature_store.py:261):
    subclasses define `_put_tensor`, `_get_tensor`, `_remove_tensor` and
    `get_all_tensor_attrs`."""

    def _put_tensor(self, tensor, attr: TensorAttr) -> bool:
        raise NotImplementedError

    def _get_tensor(self, attr: TensorAttr):
        raise NotImplementedError

    def _remove_tensor(self, attr: TensorAttr) -> bool:
        raise NotImplementedError

    def get_all_tensor_attrs(self) -> List[TensorAttr]:
        raise NotImplementedError

    # -- public surface -----------------------------------------------------
    def put_tensor(self, tensor, group_name=None, attr_name=None,
                   index=None) -> bool:
        return self._put_tensor(np.asarray(_host(tensor)),
                                TensorAttr(group_name, attr_name, index))

    def get_tensor(self, group_name=None, attr_name=None, index=None):
        out = self._get_tensor(TensorAttr(group_name, attr_name, index))
        if out is None:
            raise KeyError((group_name, attr_name))
        return out

    def multi_get_tensor(self, attrs: List[TensorAttr]):
        return [self._get_tensor(a) for a in attrs]

    def remove_tensor(self, group_name=None, attr_name=None) -> bool:
        return self._remove_tensor(TensorAttr(group_name, attr_name))

    def __setitem__(self, key: Tuple[str, str], tensor):
        self.put_tensor(tensor, key[0], key[1])

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 3:
            return self.get_tensor(key[0], key[1], key[2])
        return self.get_tensor(key[0], key[1])


class InMemoryFeatureStore(FeatureStore):
    """Numpy arrays keyed by (group, attribute); an index reads or writes
    those rows only."""

    def __init__(self):
        self._store: Dict[Tuple[str, str], np.ndarray] = {}

    def _key(self, attr):
        return (attr.group_name, attr.attr_name)

    def _put_tensor(self, tensor, attr):
        key = self._key(attr)
        if attr.index is not None:
            self._store[key][np.asarray(_host(attr.index))] = tensor
        else:
            self._store[key] = tensor
        return True

    def _get_tensor(self, attr):
        out = self._store.get(self._key(attr))
        if out is not None and attr.index is not None:
            return out[np.asarray(_host(attr.index))]
        return out

    def _remove_tensor(self, attr):
        return self._store.pop(self._key(attr), None) is not None

    def get_all_tensor_attrs(self):
        return [TensorAttr(g, a) for g, a in self._store.keys()]
