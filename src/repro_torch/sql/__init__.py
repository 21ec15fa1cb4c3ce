from repro_torch.sql.parser import parse_prediction_query
