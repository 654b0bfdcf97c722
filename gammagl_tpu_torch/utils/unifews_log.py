"""UniFews experiment logging, metrics and timing, counterpart of
`gammagl_tpu/utils/unifews_log.py` (reference: gammagl/utils/
{logger_unifews.py,metric_unifews.py}): a run directory with CSV result
rows, best-score tracking with early stop and pickled parameter
checkpoints (a module's ``state_dict()``, or any picklable tree), per-layer
kept counts, streaming F1 and a pause/lap stopwatch. Host code only.
"""

import os
import os.path as osp
import pickle
import time
import uuid

import numpy as np

__all__ = ["UniFewsLogger", "ModelLogger", "LayerNumLogger", "F1Calculator",
           "Stopwatch"]


class UniFewsLogger:
    """Per-run directory with structured print + CSV summary rows
    (reference logger_unifews.py:28-155)."""

    def __init__(self, data, algo, flag_run="", dir_base="./log"):
        self.data, self.algo = data, algo
        self.flag_run = flag_run or uuid.uuid4().hex[:8]
        self.dir_save = osp.join(dir_base, data, algo, self.flag_run)
        os.makedirs(self.dir_save, exist_ok=True)
        self.file_log = osp.join(self.dir_save, "log.txt")

    def path_join(self, *args):
        return osp.join(self.dir_save, *args)

    def print(self, s, sf=None):
        print(s)
        with open(sf or self.file_log, "a") as f:
            f.write(str(s) + "\n")

    def print_header(self, hs, s):
        self.print(hs)
        self.print(s)

    def save_opt(self, opt):
        d = dict(opt) if not hasattr(opt, "__dict__") else vars(opt)
        with open(self.path_join("opt.pkl"), "wb") as f:
            pickle.dump(d, f)
        self.print(str(d))

    def load_opt(self):
        with open(self.path_join("opt.pkl"), "rb") as f:
            return pickle.load(f)

    def str_csv(self, data, algo, seed, thr_a, thr_w, acc_test, conv_epoch,
                epoch, time_train, macs_train, time_test, macs_test,
                numel_a, numel_w):
        """One result row (reference logger_unifews.py:126-138)."""
        hstr = ("      Data|     Model|  Seed|     ThA|     ThW|    Acc|"
                "  Cn|  EP|  Ttrain|  Ctrain|   Ttest|   CTest|  NumelA|"
                "  NumelW")
        cstr = (f"{data:10s},{algo:10s},{seed:6d},{thr_a:7.2e},"
                f"{thr_w:7.2e},{acc_test:7.5f},{conv_epoch:4d},{epoch:4d},"
                f"{time_train:8.4f},{macs_train:8.3f},{time_test:8.4f},"
                f"{macs_test:8.4f},{numel_a:8.3f},{numel_w:8.3f}")
        return hstr, cstr


class ModelLogger:
    """Best-score tracking, early stop, and pickled parameter checkpoints
    (reference logger_unifews.py:157-256)."""

    def __init__(self, logger, patience=99999, prefix="model", cmp=">"):
        self.logger = logger
        self.patience = patience
        self.prefix = prefix
        if callable(cmp):
            self.cmp = cmp
        else:
            self.cmp = {">": lambda a, b: a > b,
                        "<": lambda a, b: a < b}[cmp]
        self.best_score = None
        self.best_epoch = -1
        self.last_epoch = -1
        self.params = None

    def register(self, params, save_init=True):
        self.params = params
        if save_init:
            self.save("init")

    def _path(self, *suffix):
        name = "_".join((self.prefix,) + tuple(str(s) for s in suffix))
        return self.logger.path_join(name + ".pkl")

    def save(self, *suffix, params=None):
        with open(self._path(*suffix), "wb") as f:
            pickle.dump(params if params is not None else self.params, f)

    def load(self, *suffix):
        with open(self._path(*suffix), "rb") as f:
            self.params = pickle.load(f)
        return self.params

    def save_epoch(self, epoch, params=None, period=1):
        self.last_epoch = epoch
        if epoch % period == 0:
            self.save("epoch", epoch, params=params)

    def is_best(self, score, epoch=-1):
        if self.best_score is None or self.cmp(score, self.best_score):
            self.best_score = score
            self.best_epoch = epoch
            return True
        return False

    def save_best(self, score, epoch=-1, params=None):
        if self.is_best(score, epoch):
            self.save("best", params=params)
            return True
        return False

    def is_early_stop(self, epoch=-1):
        return epoch - self.best_epoch > self.patience


class LayerNumLogger:
    """Tracks per-layer kept/total entry counts for pruning sparsity
    (reference logger_unifews.py:258-280)."""

    def __init__(self, name=None):
        self.name = name
        self.numel_before = 0
        self.numel_after = 0

    @property
    def ratio(self):
        return self.numel_after / max(self.numel_before, 1)

    def __repr__(self):
        return f"{self.numel_after}/{self.numel_before}({self.ratio:.2%})"


class F1Calculator:
    """Streaming micro/macro F1 over integer predictions (reference
    metric_unifews.py:9-50)."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.tp = np.zeros(num_classes)
        self.fp = np.zeros(num_classes)
        self.fn = np.zeros(num_classes)

    def update(self, y_true, y_pred):
        y_true = np.asarray(y_true).ravel()
        y_pred = np.asarray(y_pred).ravel()
        for c in range(self.num_classes):
            self.tp[c] += np.sum((y_pred == c) & (y_true == c))
            self.fp[c] += np.sum((y_pred == c) & (y_true != c))
            self.fn[c] += np.sum((y_pred != c) & (y_true == c))

    def compute(self, average="micro"):
        if average == "micro":
            tp, fp, fn = self.tp.sum(), self.fp.sum(), self.fn.sum()
            denom = 2 * tp + fp + fn
            return 2 * tp / denom if denom else 0.0
        prec = self.tp / np.maximum(self.tp + self.fp, 1)
        rec = self.tp / np.maximum(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        return float(f1.mean())


class Stopwatch:
    """Pause/lap timer (reference metric_unifews.py:52-80)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def pause(self):
        if self._t0 is not None:
            self.elapsed += time.perf_counter() - self._t0
            self._t0 = None
        return self.elapsed

    def lap(self):
        running = (time.perf_counter() - self._t0) if self._t0 else 0.0
        return self.elapsed + running

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.pause()
