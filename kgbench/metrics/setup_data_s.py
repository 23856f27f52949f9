"""Set-up seconds in the port's data layer: its kgwas.data.* spans but
kgwas.data.compile (the KG's transforms, the sumstats read,
process_gwas_file, prepare_split). Reads ``setup_data_s.<cell>``."""
from kgbench.metrics.spans import table_s


def read(record):
    return table_s(lambda n: n.startswith("kgwas.data.")
                   and n != "kgwas.data.compile")
