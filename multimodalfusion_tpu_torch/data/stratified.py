"""Stratified splitters of the port's own (the machine with the card has
no scikit-learn): ``StratifiedKFold(n_splits, shuffle=True,
random_state=seed)`` and ``StratifiedShuffleSplit(n_splits, test_size,
random_state=seed)`` of ``sklearn.model_selection``, drawing from numpy's
``RandomState`` in the order scikit-learn draws, so that the index sets
are the same (``_make_test_folds``, ``_iter_indices`` and
``_approximate_mode`` of scikit-learn 1.x).

Each yields (train indices, test indices) over the rows of ``y``.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np


def approximate_mode(class_counts: np.ndarray, n_draws: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """The per-class draws nearest to the multivariate hypergeometric's
    mode: floors of the proportional counts, the rest handed out by
    largest remainder, ties broken at random with ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need = int(n_draws - floored.sum())
    if need > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need -= add_now
            if need == 0:
                break
    return floored.astype(int)


def stratified_kfold(y, n_splits: int, seed: int
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``StratifiedKFold(n_splits, shuffle=True, random_state=seed)
    .split(X, y)``: each class's rows dealt round-robin over the folds in
    sorted label order, its block of fold numbers shuffled with one
    ``rng.shuffle`` per class, classes in order of first appearance."""
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} "
                         f"greater than the number of samples: "
                         f"n_samples={len(y)}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         f"number of members in each class.")
    rng = np.random.RandomState(seed)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        yield indices[test_folds != i], indices[test_folds == i]


def _n_train_test(n_samples: int, test_size: Optional[float]
                  ) -> Tuple[int, int]:
    """``_validate_shuffle_split`` for a float (or default) test size and
    no train size."""
    test_size = 0.1 if test_size is None else test_size
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         f"(0, 1) range")
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size="
                         f"{test_size} the train set would be empty.")
    return n_train, n_test


def stratified_shuffle_split(y, n_splits: int,
                             test_size: Optional[float], seed: int
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``StratifiedShuffleSplit(n_splits, test_size=test_size,
    random_state=seed).split(X, y)`` (a float ``test_size``, 0.1 when
    None): per split, the train and test counts per class by
    ``approximate_mode``, a permutation of each class's rows (in sorted
    label order), and the train and test rows permuted once more."""
    y = np.asarray(y)
    n_train, n_test = _n_train_test(len(y), test_size)
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    y_indices = y_indices.reshape(-1)
    if np.min(class_counts) < 2:
        raise ValueError(f"The least populated classes in y have only 1 "
                         f"member, which is too few: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes):
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {len(classes)}")
    if n_test < len(classes):
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    for _ in range(n_splits):
        n_i = approximate_mode(class_counts, n_train, rng)
        t_i = approximate_mode(class_counts - n_i, n_test, rng)
        train, test = [], []
        for i in range(len(classes)):
            perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                         mode="clip")
            train.extend(perm[:n_i[i]])
            test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
        yield rng.permutation(train), rng.permutation(test)
