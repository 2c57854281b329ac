"""DVB-S2: ``dvbs2`` on the table through ``parse_address_table``."""


def program_code(config: dict, text: str):
    from myldpccppapi_torch.codes.dvbs2 import dvbs2, parse_address_table

    return dvbs2(config["n"], config["rate"], addresses=parse_address_table(text))

