"""The provider's construction from the generated inputs (chains, pose
precompute, copies to the card), by the benchmark's clock."""


def read(run):
    return run.spans.get("data_load")
