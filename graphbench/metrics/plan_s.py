"""Host seconds of the port's construction from the edge list (CSR
build, format build, spec resolution, binding): `plan(edges)`."""


def read(rec):
    return rec.spans.get("plan")
