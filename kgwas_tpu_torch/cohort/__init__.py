from .ukbb import (get_fields, get_kinship_groups, get_row_last_values,
                   remove_kinships, ukbb_cohort)
