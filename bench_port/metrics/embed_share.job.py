"""Share of the jobs' wall time spent inside the embed callable (the
text tower through ``TextEmbedder``, tokenisation and read-back
included), on the host clock of the benchmark's spans."""


def read(obs):
    if not obs.get("job_s"):
        return None
    return 100.0 * obs["embed_s"] / obs["job_s"]
