"""Greedy person construction on the host (``MODEL.GC.CC_METHOD: greedy``),
the port's own copy of pemp_tpu.decode.greedy (reference:
src/Utils/Utils.py:517-626): type-ordered greedy claiming over the
symmetrised edge-score adjacency, with a claimed node moving to a core
whose edge to it scores higher. Sequential, in numpy, over one image's
nodes.
"""

from __future__ import annotations

import numpy as np


def greedy_person_construction(joint_det, preds_nodes, preds_edges, preds_classes,
                               edge_index, num_joints: int):
    """Groups one image's nodes into persons.

    joint_det (N, 3) x, y, type; preds_nodes (N,) node scores (0 for a
    node that does not count); preds_edges (E,) edge scores over
    edge_index (2, E); preds_classes (N, C) or None: the class argmax
    replaces the detected types (a background class C - 1 = J seeds and
    joins no person). Returns (persons (P, J, 3) float64, the core each
    node joined (N,), -1 for none)."""
    joint_det = np.asarray(joint_det).copy()
    preds_nodes = np.asarray(preds_nodes)
    preds_edges = np.asarray(preds_edges)
    edge_index = np.asarray(edge_index)
    if preds_classes is not None:
        joint_det[:, 2] = np.asarray(preds_classes).argmax(axis=1)

    n = len(joint_det)
    adj = np.zeros((n, n), dtype=np.float64)
    adj[edge_index[0], edge_index[1]] = preds_edges
    adj = (adj.T + adj) / 2.0
    adj[np.diag_indices(n)] = 1.0

    taken = np.full(n, -1, dtype=np.int64)
    for jtype in range(num_joints):
        for i in np.flatnonzero(joint_det[:, 2] == jtype):
            if taken[i] != -1 or preds_nodes[i] < 0.5:
                continue
            taken[i] = i
            for j in range(num_joints):
                if j == jtype:
                    continue
                # i's strongest edge to a type-j node (the first on ties)
                row = np.where(joint_det[:, 2] == j, adj[i], 0.0)
                target = int(row.argmax())
                score = row[target]
                if score == 0.0 or target == i:
                    continue
                if taken[target] != -1 and adj[taken[target], target] > score:
                    continue
                taken[target] = i

    persons = []
    for core in range(int(taken.max()) + 1 if n and taken.max() >= 0 else 0):
        sel = taken == core
        person_joints = joint_det[sel]
        person_scores = preds_nodes[sel]
        if len(person_joints) > 1:
            keypoints = np.zeros((num_joints, 3))
            for jtype in range(num_joints):
                m = person_joints[:, 2] == jtype
                if m.sum():
                    idx = int(np.argmax(person_scores[m]))
                    keypoints[jtype] = person_joints[m][idx]
                    keypoints[jtype, 2] = float(person_scores[m].max())
            if (keypoints[:, 2] > 0).sum() > 0:
                persons.append(keypoints)
    return np.asarray(persons, np.float64).reshape(-1, num_joints, 3), taken
