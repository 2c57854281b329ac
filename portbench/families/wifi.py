"""802.11n: the port's ``QCCode`` on the table's prototype matrix."""


def program_code(config: dict, text: str):
    import numpy as np

    from myldpccppapi_torch.codes.qc import QCCode

    rows = [line.split("#", 1)[0].split() for line in text.splitlines()]
    base = np.asarray([[int(t) for t in row] for row in rows if row], dtype=np.int32)
    return QCCode(name=config["name"], base=base, z=config["z"])
