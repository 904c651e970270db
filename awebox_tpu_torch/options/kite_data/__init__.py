from . import ampyx_data, ampyx_ap2_settings
