"""Data-pipeline dedup with Dash-LH on PyTorch (the port, ``repro_torch``):
the paper's sustained-insert workload as a production pipeline stage.

    PYTHONPATH=src python examples/dedup_pipeline_torch.py                # on the card
    PYTHONPATH=src python examples/dedup_pipeline_torch.py --device cpu   # on the CPU

Twin of ``examples/dedup_pipeline.py``; ``--batches`` sets the run length.
"""
import argparse

from repro_torch.data import DedupFilter, PackedBatcher, PipelineConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
ap.add_argument("--batches", type=int, default=30, help="packed batches to draw")
args = ap.parse_args()

pc = PipelineConfig(vocab_size=32000, seq_len=512, batch_size=8,
                    dup_fraction=0.25, doc_len_min=32, doc_len_max=96)
dedup = DedupFilter(device=args.device)
batcher = PackedBatcher(pc, dedup=dedup)

for i in range(args.batches):
    batcher.next_batch()
    if i % 10 == 9 or i == args.batches - 1:
        print(f"batch {i+1}: docs seen {batcher.docs_seen}, "
              f"duplicates skipped {batcher.docs_skipped} "
              f"({batcher.docs_skipped/max(batcher.docs_seen,1):.1%}), "
              f"dash-lh items {dedup.unique_docs} "
              f"lf={dedup.table.load_factor:.2f} "
              f"segments={dedup.table.n_segments}")
assert dedup.unique_docs == batcher.docs_seen - batcher.docs_skipped
