"""The comparisons that decide `correct`, beside the reference they run.

Multistate cells.  Clustering is a discrete function of the features: at
the configured eigenvalue threshold one count can flip on a last-bit
difference, and a flipped count changes every later layer.  An independent
forward can therefore not be held to the program's partition.  So the
reference follows the program step by step: each clustering event of a
pool batch's latest forward is recomputed from the program's own inputs to
it (its parents and features) with the draws the reference derives from the
batch's seed, and the trunk is recomputed in float32 from the pixels with
the program's partitions in place of its own clustering.  Every batch of
the window is then held to the reference of its pool batch, and the
features each event clustered to the reference trunk's features at that
layer.

The program's events are read through a hook on the clustering call of the
port's re-clustering step (`programs.ClusteringRecorder`): a dependency of
this yardstick on where the port makes that call.  A forward whose events
the hook did not see in full counts as differing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from perfbench.reference import vit as ref
from perfbench.reference.clustering import spectral_cluster
from perfbench.reference.rng import Stream
from perfbench.stats import rel_err


def multistate(sd: Dict, cfg: Dict, pool: Sequence[torch.Tensor], seeds: Sequence[int],
               outputs: List, events: Dict[int, List[Dict]]) -> Dict[str, float]:
    """outputs: (pool index, last hidden state, last partition, number of
    clusters) of every forward of the window; events: pool index -> the
    clustering events of its latest forward.  Returns the numbers compared:
    the largest relative error of an image's last hidden state, and of an
    image's features at a clustering event, the largest share of tokens
    whose cluster differs (an event's children, or a batch's last
    partition), and the count of events and batches whose draws, children
    per parent or number of clusters differ, or whose events were not all
    seen."""
    cl = cfg["clustering"]
    layers = range(cfg["num_hidden_layers"])
    n_events = sum(i >= cfg["pregeneration_period"] and i % cfg["generation_period"] == 0
                   for i in layers)
    hidden, features, parts, differ = 0.0, 0.0, 0.0, 0
    want = {}
    for j, evs in events.items():
        if len(evs) != n_events:
            differ += 1
            continue
        stream = Stream(seeds[j])
        for e in evs:
            stream, key = stream.split(2)
            child, per_parent = spectral_cluster(cl, e["parents"], e["x"], key,
                                                 e["max_parents"])
            differ += int(key.seed != e["key"])
            differ += int(not torch.equal(per_parent.cpu(), e["n_children"].cpu()))
            parts = max(parts, float((child != e["child"]).float().mean()))
        want[j] = ref.multistate_forward(sd, cfg, pool[j], seeds[j],
                                         forced=[(e["child"], e["n_children"]) for e in evs])
        for e, w in zip(evs, want[j]["events"]):
            features = max(features, float(rel_err(e["x"], w["x"]).max()))
    for j, lh, ids, nc in outputs:
        r = want.get(j)
        if r is None:
            differ += 1
            continue
        hidden = max(hidden, float(rel_err(lh, r["last_hidden_state"]).max()))
        parts = max(parts, float((ids != r["last_cluster_indices"]).float().mean()))
        differ += int(int(nc) != int(r["num_clusters"]))
    return {"hidden_rel_err": hidden, "features_rel_err": features,
            "partition_differs": parts, "clusters_differ": float(differ)}
