"""Share of the solve calls' predicts served by replayed CUDA graphs: the mean rise of the program's counter predict_graph.replay over its span lapgnn.predict, x100 (%); none where the program has no such counter."""

from lapbench import program_spans


def read(rec):
    try:
        from lapgnn_tpu_torch import tracing
    except ImportError:
        return None
    if "predict_graph.replay" not in tracing.counters():
        return None
    share = program_spans.mean_count("lapgnn.predict", "predict_graph.replay")
    return None if share is None else 100.0 * share
