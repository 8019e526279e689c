"""Optional pyspark adapter: the warehouse pull/write seam.

Copied from ``multimodalsimilar_tpu/pipelines/spark.py`` (it imports no
JAX), with pandas imported at call time as well as pyspark, since the
card machine has neither. The reference's daily jobs all share one I/O
shape: a Hive-backed SparkSession pulls the day's rows
(``spark.sql(...).toPandas()`` — nlp_infer.py:112-116,
goodssku_emb_bert_di.py:111-129), the embeddings are computed
in-process, and the result goes back via a tmp table plus ``INSERT
OVERWRITE`` (goodssku_emb_bert_di.py:144-154). The port's ``read_table``
routes ``hive://db.table`` and ``hivesql://<SQL>`` through
``SparkTableSource``, and ``cli/common.py:_make_table_sink`` routes
``hive://`` tables to ``SparkTableSink``:

    spark = spark_session("goodssku_emb_calc_bert")
    df = SparkTableSource(spark).sql(PULL_QUERY)          # -> pandas
    SparkTableSink(spark, "dm_recommend.goodssku_embedding_bert",
                   key_col="goods_sku").overwrite(result)

The adapter raises one clear error when pyspark is absent.
"""

from __future__ import annotations

from typing import Mapping, Optional

from multimodalsimilar_tpu_torch.pipelines.sinks import TableSink


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:  # pragma: no cover - exercised via stub tests
        raise ImportError(
            "pyspark is not installed in this environment. The Spark "
            "adapter only runs on a cluster host; everywhere else export "
            "the warehouse query to parquet and point --data at it "
            "(a parquet or CSV file).") from e


def spark_session(app_name: str, ui_port: int = 4060,
                  conf: Optional[Mapping[str, str]] = None):
    """Hive-enabled session, configured the way every reference job does it
    (goodssku_emb_bert_di.py:105-109: app name + spark.ui.port, then
    ``enableHiveSupport().getOrCreate()``, log level ERROR)."""
    _require_pyspark()
    from pyspark import SparkConf
    from pyspark.sql import SparkSession

    sc_conf = SparkConf()
    sc_conf.set("spark.app.name", app_name)
    sc_conf.set("spark.ui.port", str(ui_port))
    for k, v in (conf or {}).items():
        sc_conf.set(k, str(v))
    spark = (SparkSession.builder.config(conf=sc_conf)
             .enableHiveSupport().getOrCreate())
    spark.sparkContext.setLogLevel("ERROR")
    return spark


class SparkTableSource:
    """The pull seam: ``spark.sql(query).toPandas()``.

    Every reference entry point starts this way (nlp_infer.py:112-116,
    daodian_infer.py:331-345, goodssku_emb.py:151-162); the resulting
    pandas frame is what this repo's sources/pipelines consume, so the
    adapter is just the boundary crossing plus the same row-count log line
    the jobs print."""

    def __init__(self, spark):
        self.spark = spark

    def sql(self, query: str, log: bool = True):
        df = self.spark.sql(query).toPandas()
        if log:
            print(f"spark pull: {len(df)} rows", flush=True)
        return df


def _string_schema(df, key_col: Optional[str]):
    """All-string StructType with the key column non-nullable — the
    reference declares its warehouse tables exactly so
    (goodssku_emb_bert_di.py:139-143: goods_sku nullable=False, the
    embedding/modifydate strings nullable=True)."""
    from pyspark.sql.types import StringType, StructField, StructType
    return StructType([
        StructField(c, StringType(), not (key_col is not None
                                          and c == key_col))
        for c in df.columns])


class SparkTableSink(TableSink):
    """Hive writes with the reference's exact overwrite discipline:
    repartition -> saveAsTable(tmp) -> INSERT OVERWRITE target
    (goodssku_emb_bert_di.py:148-154). ParquetTableSink mirrors the same
    contract off-cluster."""

    def __init__(self, spark, table: str, key_col: Optional[str] = None,
                 tmp_table: Optional[str] = None, repartition: int = 3000):
        _require_pyspark()
        self.spark = spark
        self.table = table
        self.key_col = key_col
        # tmp.tmp_<basename> is the reference's naming for the staging
        # table (goodssku_emb_bert_di.py:150)
        self.tmp_table = tmp_table or f"tmp.tmp_{table.split('.')[-1]}"
        self.repartition = repartition

    def _exists(self) -> bool:
        """Target-table existence — a brand-new warehouse table must act
        like ParquetTableSink's missing file (empty keys / empty read /
        create-on-first-write), not raise AnalysisException.

        Only a MISSING table maps to False. A transient metastore or
        connection error must PROPAGATE: swallowing it would route
        append()/overwrite() into the create branch, whose
        mode('overwrite').saveAsTable would silently replace the whole
        warehouse table with one flush chunk."""
        cat = getattr(self.spark, "catalog", None)
        if cat is not None and hasattr(cat, "tableExists"):
            # returns False for a missing table; raises on real errors
            return bool(cat.tableExists(self.table))
        try:
            self.spark.sql(f"describe table {self.table}")
            return True
        except Exception as e:
            msg = str(e).lower()
            if "not found" in msg or "not exist" in msg \
                    or "table_or_view_not_found" in msg:
                return False
            raise

    def existing_keys(self, key_col: str) -> set:
        if not self._exists():
            return set()
        df = self.spark.sql(
            f"select distinct {key_col} from {self.table}").toPandas()
        return set(df[key_col]) if len(df) else set()

    def read(self):
        if not self._exists():
            import pandas as pd
            return pd.DataFrame()
        return self.spark.sql(f"select * from {self.table}").toPandas()

    def _stage(self, df, table: str) -> None:
        schema = _string_schema(df, self.key_col)
        # fillna BEFORE astype: bulk_export's outer merge leaves NaN for
        # keys missing a tower, and astype(str) would write literal 'nan'
        # strings — the reference writes '' (goodssku_emb.py:185 fillna(''))
        sdf = self.spark.createDataFrame(df.fillna("").astype(str), schema)
        (sdf.repartition(self.repartition)
            .write.mode("overwrite").saveAsTable(table))

    def overwrite(self, df) -> None:
        if not self._exists():
            # nothing to preserve: create the target directly
            self._stage(df, self.table)
            return
        self._stage(df, self.tmp_table)
        self.spark.sql(
            f"insert overwrite table {self.table} "
            f"select * from {self.tmp_table}")

    def append(self, df) -> None:
        # The reference's daily job reads the table ONCE, unions in memory,
        # and overwrites ONCE at the end (goodssku_emb_bert_di.py:126-155).
        # incremental_export instead flushes every flush_rows for bounded
        # memory + crash-resumability, so append must not read-modify-write
        # the warehouse per flush (quadratic toPandas + INSERT OVERWRITE of
        # a growing multi-GB table): stage the new rows and INSERT INTO.
        # Key-disjointness is the caller's contract (existing_keys
        # pre-filter), same as ParquetTableSink's chunked appends.
        if not self._exists():
            self._stage(df, self.table)
            return
        self._stage(df, self.tmp_table)
        self.spark.sql(
            f"insert into table {self.table} "
            f"select * from {self.tmp_table}")
