/* A reader of host NVLink snapshot DBs, for the fleet loader
 * (gpud_tpu_torch/snapshot_reader.py wraps it with ctypes).
 *
 * tpud_open opens a DB read-only through a URI, as Python's sqlite3 does
 * (busy timeout 5,000 ms), and reads the tombstone table. The window's query
 * then writes each row straight into its host's block (tpud_block): one row
 * of [links, t] int8 states, int32 counters and valid flags a link, the row's
 * samples left-aligned in ts order. A sample before its link's set-healthy
 * floor is dropped as it arrives; a link keeps its latest max_samples
 * samples, its counter rebased on the first kept one and clipped to int32. A
 * link whose counter once left int32 keeps a ring of its raw counters too, so
 * that a cut rebases it exactly. The block (counters, then states, then valid
 * flags) lives in pages mapped for it alone, apart from malloc's heap, so they
 * go back to the system the moment the caller lets it go; it is packed to its
 * final shape where it was written, and handed to the caller.
 *
 * A host over several DBs has one block: the walk of each of its DBs after
 * the first continues the block where the DB before left it, each link
 * already in it taking this DB's floor, and the host's last DB closes it.
 *
 * A value this side does not convert itself (a NULL, TEXT or BLOB number, a
 * REAL state or CRC, a state outside int8) stops the walk with TPUD_VALUE; the
 * caller converts it, and tpud_resume stores the result and walks on.
 * Tombstones this side does not judge stop the read with TPUD_FLOORS before
 * its walk; the caller judges them and hands the floors to tpud_walk. At the
 * end the DB is closed and what only the walk used is freed, so that a read
 * waiting to be taken holds little; what the caller reads lives until
 * tpud_close.
 *
 * A pool (tpud_pool_start) reads a list of DBs as the loader asks for them.
 * Worker threads of small stacks each read a DB whole, at most a window of
 * DBs ahead of the last one taken: open it, judge its tombstones into floors
 * and, for a host's first DB, make its block, walk it to the end and close
 * the DB. The thread that takes the DBs in order (tpud_pool_take) walks a DB
 * that continues a block, or whose floors the caller judged, itself. Each
 * thread allocates for itself; a worker's memory comes from a malloc arena of
 * its own, which the next load's workers reuse. Where the pool has no
 * thread, the taking thread reads each DB.
 *
 * SQLite's header is not needed: the few functions used are declared here,
 * and the library is the one the interpreter's sqlite3 module loaded.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <time.h>
#include <unistd.h>

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;

int sqlite3_open_v2(const char *filename, sqlite3 **db, int flags, const char *vfs);
int sqlite3_busy_timeout(sqlite3 *db, int ms);
int sqlite3_close_v2(sqlite3 *db);
int sqlite3_exec(sqlite3 *db, const char *sql, void *callback, void *arg, char **errmsg);
int sqlite3_db_config(sqlite3 *db, int op, ...);
int sqlite3_extended_errcode(sqlite3 *db);
const char *sqlite3_errmsg(sqlite3 *db);
int sqlite3_prepare_v2(sqlite3 *db, const char *sql, int n, sqlite3_stmt **stmt, const char **tail);
int sqlite3_bind_double(sqlite3_stmt *stmt, int i, double v);
int sqlite3_step(sqlite3_stmt *stmt);
int sqlite3_finalize(sqlite3_stmt *stmt);
int sqlite3_column_type(sqlite3_stmt *stmt, int i);
int64_t sqlite3_column_int64(sqlite3_stmt *stmt, int i);
double sqlite3_column_double(sqlite3_stmt *stmt, int i);
const void *sqlite3_column_blob(sqlite3_stmt *stmt, int i);
const unsigned char *sqlite3_column_text(sqlite3_stmt *stmt, int i);
int sqlite3_column_bytes(sqlite3_stmt *stmt, int i);

#define SQLITE_OK 0
#define SQLITE_ERROR 1
#define SQLITE_NOMEM 7
#define SQLITE_ROW 100
#define SQLITE_DONE 101
#define SQLITE_INTEGER 1
#define SQLITE_FLOAT 2
#define SQLITE_TEXT 3
#define SQLITE_BLOB 4
#define SQLITE_NULL 5
#define SQLITE_OPEN_READONLY 0x00000001
#define SQLITE_OPEN_URI 0x00000040
#define SQLITE_OPEN_NOMUTEX 0x00008000
#define SQLITE_DBCONFIG_LOOKASIDE 1001

#define TPUD_VALUE 1000 /* a value for the caller to convert */
#define TPUD_FLOORS 1002 /* tombstones only the caller can judge: no walk started */
#define BUSY_TIMEOUT_MS 5000 /* Python's sqlite3.connect(timeout=5.0) */
/* the window's walk visits each index and table page once, in order: the
 * few pages on the paths from the two b-trees' roots serve it, where
 * SQLite's default holds 2 MB a connection. Set before the first page is
 * read, it also bounds the pages SQLite allocates at once for the cache,
 * so a walk allocates none. A pool holds a DB open on each of its workers:
 * each keeps this little, and no lookaside buffer */
#define WALK_CACHE "PRAGMA cache_size=8"

/* One value as SQLite typed it; TEXT and BLOB bytes at p, n long. */
typedef struct {
    int64_t type;
    int64_t i;
    double f;
    const char *p;
    int64_t n;
} tpud_value;

/* Names, numbered in the order added; looked up by open addressing. */
typedef struct {
    int64_t n;
    char *names;            /* end to end: name k's */
    int64_t *ends;          /* ends at ends[k], starts at the end before */
    int64_t names_cap;
    int64_t ends_cap;
    int64_t *slots;         /* id + 1, 0 empty */
    int64_t n_slots;
} name_table;

/* A host's block, written by the walks of its DBs in turn. */
typedef struct {
    /* read by the caller (the ctypes Structure mirrors these fields) */
    name_table links;       /* the link names by id, in the order first fetched */
    int64_t *kept;          /* samples a link kept, before the cut */
    int64_t t;              /* once closed, the block is [links.n, t] */
    char *buf;              /* counters, then states, then valid flags */
    int64_t bytes;          /* and the bytes mapped for them */
    /* private */
    int64_t max_samples;
    int64_t links_cap;      /* the rows and samples held */
    int64_t t_cap;
    int32_t *counter;       /* in buf */
    int8_t *state;
    uint8_t *valid;
    int64_t *base;          /* per link: the counter of its first sample */
    double *floor;          /* its floor in the DB being walked */
    int64_t **raw;          /* once its counter left int32, its raw counters, t_cap of them */
} tpud_block;

typedef struct {
    /* read by the caller (the ctypes Structure mirrors these fields) */
    int64_t errcode;        /* SQLite's extended code of the last failure */
    char *errmsg;           /* and its message */
    int64_t tomb_rc;        /* the tombstone read's result: 0 or a failure */
    int64_t n_tombstones;
    tpud_value *tombstones; /* link, ts of each row */
    int64_t n_rows;         /* rows fetched */
    int64_t n_tombstoned;   /* of them, dropped by a floor */
    int64_t bad_col;        /* the column of the value to convert */
    tpud_value bad;
    tpud_block *b;          /* the host's block, which the walk writes */
    /* private */
    int owns;               /* the host's last DB: its walk closes the block, tpud_close frees it */
    sqlite3 *db;
    sqlite3_stmt *stmt;
    int32_t r_lid;          /* the row being read */
    double r_ts;
    int8_t r_state;
    int64_t r_crc;
    name_table floors;      /* tombstoned link names, their floors in floor_of */
    double *floor_of;
    double floor0;          /* the floor of a link without a tombstone */
} tpud_reader;

typedef struct {
    struct tpud_job *jobs;
    int64_t n;
    int64_t window;         /* jobs read ahead of the last one taken, at most */
    int64_t next;           /* the next job a worker reads */
    int64_t taken;          /* the jobs the caller took */
    int64_t links_hint;     /* the largest block yet: the next one's first size */
    int64_t t_hint;
    int8_t *done;
    int stop;
    pthread_mutex_t mu;
    pthread_cond_t cv;      /* a job read or taken, the stop */
    pthread_t *threads;
    int64_t n_threads;
} tpud_pool;

static int64_t page_up(int64_t n) {
    int64_t page = sysconf(_SC_PAGESIZE);
    return (n + page - 1) / page * page;
}

/* Zeroed pages of n bytes, mapped for them alone; NULL where there are none. */
static void *map_pages(int64_t n) {
    void *p = mmap(NULL, n, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    return p == MAP_FAILED ? NULL : p;
}

/* Unmaps n bytes of pages that map_pages mapped. */
void tpud_unmap(void *p, int64_t n) {
    if (p && n > 0) munmap(p, page_up(n));
}

/* `old`'s first `used` bytes in new zeroed memory of `bytes`, `old` freed;
 * NULL out of memory. */
static void *regrow(void *old, int64_t used, int64_t bytes) {
    char *p = calloc(bytes, 1);
    if (!p) return NULL;
    if (used) memcpy(p, old, used);
    free(old);
    return p;
}

/* A copy of n bytes, NUL-terminated. */
static char *copy_bytes(const void *p, int64_t n) {
    char *out = calloc(n + 8, 1);
    if (out && n) memcpy(out, p, n);
    return out;
}

/* Keeps SQLite's code and message of a failure; returns its primary code. */
static int fail(tpud_reader *h, int rc) {
    const char *msg = h->db ? sqlite3_errmsg(h->db) : "out of memory";
    h->errcode = h->db ? sqlite3_extended_errcode(h->db) : rc;
    free(h->errmsg);
    h->errmsg = copy_bytes(msg, strlen(msg));
    return rc & 0xff;
}

/* The column's value; TEXT and BLOB bytes stay SQLite's until the next step. */
static tpud_value column_value(sqlite3_stmt *st, int c) {
    tpud_value v = {sqlite3_column_type(st, c), 0, 0.0, NULL, 0};
    if (v.type == SQLITE_INTEGER) {
        v.i = sqlite3_column_int64(st, c);
    } else if (v.type == SQLITE_FLOAT) {
        v.f = sqlite3_column_double(st, c);
    } else if (v.type == SQLITE_TEXT || v.type == SQLITE_BLOB) {
        v.p = v.type == SQLITE_TEXT ? (const char *)sqlite3_column_text(st, c)
                                    : (const char *)sqlite3_column_blob(st, c);
        v.n = sqlite3_column_bytes(st, c);
    }
    return v;
}

static void finish(tpud_reader *h) {
    if (h->stmt) sqlite3_finalize(h->stmt);
    h->stmt = NULL;
    if (h->db) sqlite3_close_v2(h->db);
    h->db = NULL;
}

static void free_values(tpud_value *v, int64_t n) {
    for (int64_t k = 0; k < n; k++) free((void *)v[k].p);
    free(v);
}

static int read_tombstones(tpud_reader *h, const char *sql) {
    int64_t cap = 0;
    int rc = sqlite3_prepare_v2(h->db, sql, -1, &h->stmt, NULL);
    while (rc == SQLITE_OK) {
        if ((rc = sqlite3_step(h->stmt)) != SQLITE_ROW) break;
        rc = SQLITE_OK;
        if (h->n_tombstones == cap) {
            cap = cap ? 2 * cap : 16;
            tpud_value *t = realloc(h->tombstones, 2 * cap * sizeof *t);
            if (!t) return SQLITE_NOMEM;
            h->tombstones = t;
        }
        tpud_value *row = &h->tombstones[2 * h->n_tombstones++];
        row[0].p = row[1].p = NULL; /* what tpud_close frees, if a copy fails */
        for (int c = 0; c < 2; c++) {
            tpud_value v = column_value(h->stmt, c);
            if (v.p && !(v.p = copy_bytes(v.p, v.n))) return SQLITE_NOMEM;
            row[c] = v;
        }
    }
    sqlite3_finalize(h->stmt);
    h->stmt = NULL;
    return rc == SQLITE_DONE ? SQLITE_OK : fail(h, rc);
}

int tpud_open(const char *uri, const char *tombstone_sql, tpud_reader **out) {
    tpud_reader *h = calloc(1, sizeof *h);
    *out = h;
    if (!h) return SQLITE_NOMEM;
    /* one thread uses the connection at a time: no mutex on each column read */
    int rc = sqlite3_open_v2(uri, &h->db,
                             SQLITE_OPEN_READONLY | SQLITE_OPEN_URI | SQLITE_OPEN_NOMUTEX, NULL);
    if (rc != SQLITE_OK) return fail(h, rc);
    sqlite3_busy_timeout(h->db, BUSY_TIMEOUT_MS);
    /* memory settings of this handle alone; a DB they fail on fails the
     * reads after them the same way */
    sqlite3_db_config(h->db, SQLITE_DBCONFIG_LOOKASIDE, NULL, 0, 0);
    sqlite3_exec(h->db, WALK_CACHE, NULL, NULL, NULL);
    h->tomb_rc = read_tombstones(h, tombstone_sql);
    return SQLITE_OK;
}

static uint64_t hash_bytes(const unsigned char *p, int64_t n) {
    uint64_t x = 1469598103934665603ull; /* FNV-1a */
    for (int64_t k = 0; k < n; k++) x = (x ^ p[k]) * 1099511628211ull;
    return x;
}

static uint64_t name_slot(const char *p, int64_t n, int64_t n_slots) {
    return hash_bytes((const unsigned char *)p, n) & (n_slots - 1);
}

static int same_name(const name_table *t, int64_t k, const char *p, int64_t n) {
    int64_t start = k ? t->ends[k - 1] : 0;
    return t->ends[k] - start == n && memcmp(t->names + start, p, n) == 0;
}

/* The table's slots, n of them (a power of 2). */
static int grow_slots(name_table *t, int64_t n) {
    int64_t *slots = calloc(n, sizeof *slots);
    if (!slots) return SQLITE_NOMEM;
    for (int64_t k = 0, start = 0; k < t->n; start = t->ends[k++]) {
        uint64_t s = name_slot(t->names + start, t->ends[k] - start, n);
        while (slots[s]) s = (s + 1) & (n - 1);
        slots[s] = k + 1;
    }
    free(t->slots);
    t->slots = slots;
    t->n_slots = n;
    return SQLITE_OK;
}

/* Room in the table for `names` names of `bytes` bytes in all. */
static int reserve_names(name_table *t, int64_t names, int64_t bytes) {
    void *p;
    if (names > t->ends_cap) {
        if (!(p = regrow(t->ends, t->n * sizeof *t->ends, names * sizeof *t->ends)))
            return SQLITE_NOMEM;
        t->ends = p;
        t->ends_cap = names;
    }
    if (bytes > t->names_cap) {
        if (!(p = regrow(t->names, t->n ? t->ends[t->n - 1] : 0, bytes))) return SQLITE_NOMEM;
        t->names = p;
        t->names_cap = bytes;
    }
    int64_t slots = t->n_slots ? t->n_slots : 256;
    while (slots < 2 * names) slots *= 2;
    return slots > t->n_slots ? grow_slots(t, slots) : SQLITE_OK;
}

/* The name's id; a name not held is added, numbered next (-1 out of
 * memory), or with add 0 is -2. */
static int64_t name_id(name_table *t, const char *p, int64_t n, int add) {
    if (!t->slots && grow_slots(t, 256)) return -1;
    uint64_t s = name_slot(p, n, t->n_slots);
    for (; t->slots[s]; s = (s + 1) & (t->n_slots - 1)) {
        if (same_name(t, t->slots[s] - 1, p, n)) return t->slots[s] - 1;
    }
    if (!add) return -2;
    int64_t id = t->n, used = id ? t->ends[id - 1] : 0;
    if (id == t->ends_cap || used + n > t->names_cap) {
        /* the slots double with the names: find the new one's again */
        if (reserve_names(t, id ? 2 * id : 256, 2 * (used + n) + 4096)) return -1;
        return name_id(t, p, n, add);
    }
    if (n) memcpy(t->names + used, p, n);
    t->ends[id] = used + n;
    t->n++;
    t->slots[s] = id + 1;
    return id;
}

static void free_names(name_table *t) {
    free(t->names);
    free(t->ends);
    free(t->slots);
}

/* The block [links_cap, t_cap] laid out anew as [links, t]: zeroed, each
 * row's samples kept, and each raw ring t long. */
static int resize_block(tpud_reader *h, int64_t links, int64_t t) {
    tpud_block *b = h->b;
    int64_t keep = b->t_cap < t ? b->t_cap : t;
    int64_t rows = b->links_cap < links ? b->links_cap : links;
    if (b->links.n < rows) rows = b->links.n;
    for (int64_t k = 0; k < rows && t != b->t_cap; k++) {
        int64_t *raw = b->raw[k] ? regrow(b->raw[k], keep * 8, t * 8) : NULL;
        if (b->raw[k] && !raw) return SQLITE_NOMEM;
        b->raw[k] = raw;
    }
    int64_t cells = links * t;
    char *buf = map_pages(cells * 6);
    if (!buf) return SQLITE_NOMEM;
    int32_t *ct = (int32_t *)buf;
    int8_t *st = (int8_t *)(buf + cells * 4);
    uint8_t *vd = (uint8_t *)(buf + cells * 5);
    for (int64_t k = 0; k < rows; k++) {
        memcpy(ct + k * t, b->counter + k * b->t_cap, keep * 4);
        memcpy(st + k * t, b->state + k * b->t_cap, keep);
        memcpy(vd + k * t, b->valid + k * b->t_cap, keep);
    }
    tpud_unmap(b->buf, b->bytes);
    b->buf = buf;
    b->bytes = cells * 6;
    b->counter = ct;
    b->state = st;
    b->valid = vd;
    b->links_cap = links;
    b->t_cap = t;
    return SQLITE_OK;
}

/* The per-link state and the block's rows for `cap` links. */
static int reserve_links(tpud_reader *h, int64_t cap) {
    tpud_block *b = h->b;
    int64_t n = b->links.n < b->links_cap ? b->links.n : b->links_cap;
    void *p;
    if (!(p = regrow(b->kept, n * 8, cap * 8))) return SQLITE_NOMEM;
    b->kept = p;
    if (!(p = regrow(b->base, n * 8, cap * 8))) return SQLITE_NOMEM;
    b->base = p;
    if (!(p = regrow(b->floor, n * 8, cap * 8))) return SQLITE_NOMEM;
    b->floor = p;
    if (!(p = regrow(b->raw, n * 8, cap * 8))) return SQLITE_NOMEM;
    b->raw = p;
    int64_t t = b->t_cap ? b->t_cap : 64;
    return resize_block(h, cap, t < b->max_samples ? t : b->max_samples);
}

/* Link k's floor in this DB: its tombstone's, else that of a link without. */
static int link_floor(tpud_reader *h, int64_t k) {
    tpud_block *b = h->b;
    int64_t start = k ? b->links.ends[k - 1] : 0;
    int64_t f = h->floors.n
        ? name_id(&h->floors, b->links.names + start, b->links.ends[k] - start, 0) : -2;
    if (f == -1) return SQLITE_NOMEM;
    b->floor[k] = f >= 0 ? h->floor_of[f] : h->floor0;
    return SQLITE_OK;
}

/* Room for link k, first seen: its row of the block, its per-link state. */
static int add_link(tpud_reader *h, int64_t k) {
    tpud_block *b = h->b;
    if (k >= b->links_cap && reserve_links(h, 2 * b->links_cap > 256 ? 2 * b->links_cap : 256))
        return SQLITE_NOMEM;
    return link_floor(h, k);
}

/* Link k's raw counters from here on: a ring beside its row, its `n`
 * samples so far filled in (none was clipped, so base + delta is exact). */
static int keep_raw(tpud_reader *h, int64_t k, int64_t n) {
    tpud_block *b = h->b;
    int64_t *raw = calloc(b->t_cap, 8);
    if (!raw) return SQLITE_NOMEM;
    for (int64_t j = 0; j < n && j < b->t_cap; j++)
        raw[j] = (int64_t)((uint64_t)b->base[k] + (uint64_t)(int64_t)b->counter[k * b->t_cap + j]);
    b->raw[k] = raw;
    return SQLITE_OK;
}

/* The row just read, into its link's row of the block. */
static int put(tpud_reader *h) {
    tpud_block *b = h->b;
    int64_t k = h->r_lid, n = b->kept[k];
    if (!(h->r_ts >= b->floor[k])) {
        h->n_tombstoned++;
        return SQLITE_OK;
    }
    /* past max_samples, a link's row is a ring over its latest samples */
    int64_t at = n < b->max_samples ? n : n % b->max_samples;
    if (at >= b->t_cap) {
        int64_t t = 2 * b->t_cap > 64 ? 2 * b->t_cap : 64;
        if (resize_block(h, b->links_cap, t < b->max_samples ? t : b->max_samples))
            return SQLITE_NOMEM;
    }
    if (n == 0) b->base[k] = h->r_crc;
    /* as NumPy subtracts int64: wrapping */
    int64_t d = (int64_t)((uint64_t)h->r_crc - (uint64_t)b->base[k]);
    if (b->raw[k] || d < INT32_MIN || d > INT32_MAX) {
        if (!b->raw[k] && keep_raw(h, k, n)) return SQLITE_NOMEM;
        b->raw[k][at] = h->r_crc;
        d = d < INT32_MIN ? INT32_MIN : d > INT32_MAX ? INT32_MAX : d;
    }
    at += k * b->t_cap;
    b->state[at] = h->r_state;
    b->counter[at] = (int32_t)d;
    b->valid[at] = 1;
    b->kept[k] = n + 1;
    return SQLITE_OK;
}

static void reverse(int8_t *s, int32_t *c, int64_t a, int64_t b) {
    for (b--; a < b; a++, b--) {
        int8_t x = s[a];
        s[a] = s[b];
        s[b] = x;
        int32_t y = c[a];
        c[a] = c[b];
        c[b] = y;
    }
}

/* The block packed to [links.n, t] where it is, its pages past that
 * unmapped: each array's rows move down, in address order, so none is
 * overwritten before it moved. */
static void pack_block(tpud_block *b, int64_t t) {
    int64_t links = b->links.n, cells = links * t;
    int32_t *ct = (int32_t *)b->buf;
    int8_t *st = (int8_t *)(b->buf + cells * 4);
    uint8_t *vd = (uint8_t *)(b->buf + cells * 5);
    for (int64_t k = 0; k < links; k++)
        memmove(ct + k * t, b->counter + k * b->t_cap, t * 4);
    for (int64_t k = 0; k < links; k++)
        memmove(st + k * t, b->state + k * b->t_cap, t);
    for (int64_t k = 0; k < links; k++)
        memmove(vd + k * t, b->valid + k * b->t_cap, t);
    int64_t keep = page_up(cells * 6), mapped = page_up(b->bytes);
    if (mapped > keep) munmap(b->buf + keep, mapped - keep);
    if (!cells) b->buf = NULL;
    b->bytes = cells * 6;
    b->counter = (int32_t *)b->buf;
    b->state = (int8_t *)(b->buf + cells * 4);
    b->valid = (uint8_t *)(b->buf + cells * 5);
    b->links_cap = links;
    b->t_cap = t;
}

/* The end of a host's block: each cut link's ring in ts order and rebased
 * on its first kept sample (from its raw counters where it has them: its
 * stored deltas were clipped), the block packed to its shape. */
static int close_block(tpud_reader *h) {
    tpud_block *b = h->b;
    int64_t t = 0, m = b->max_samples;
    for (int64_t k = 0; k < b->links.n; k++) {
        int64_t n = b->kept[k] < m ? b->kept[k] : m, *raw = b->raw[k];
        if (n > t) t = n;
        if (b->kept[k] > m) {
            int8_t *s = b->state + k * b->t_cap;
            int32_t *c = b->counter + k * b->t_cap;
            int64_t oldest = b->kept[k] % m;
            reverse(s, c, 0, oldest);
            reverse(s, c, oldest, m);
            reverse(s, c, 0, m);
            /* the stored deltas fit int32: their differences are exact */
            int64_t c0 = raw ? raw[oldest] : c[0];
            for (int64_t j = 0; j < m; j++) {
                int64_t d = raw ? (int64_t)((uint64_t)raw[(oldest + j) % m] - (uint64_t)c0)
                                : c[j] - c0;
                c[j] = (int32_t)(d < INT32_MIN ? INT32_MIN : d > INT32_MAX ? INT32_MAX : d);
            }
        }
        free(raw);
        b->raw[k] = NULL;
    }
    if (b->buf && (b->links_cap != b->links.n || b->t_cap != t)) pack_block(b, t);
    b->t = t;
    /* the walks' own state goes: the caller reads the names, kept and pages */
    free(b->base);
    free(b->floor);
    free(b->raw);
    free(b->links.slots);
    b->base = NULL;
    b->floor = NULL;
    b->raw = NULL;
    b->links.slots = NULL;
    b->links.n_slots = 0;
    return SQLITE_DONE;
}

/* Columns c0.. of the row being read, into the block; TPUD_VALUE where the
 * caller converts. */
static int fill(tpud_reader *h, int c0) {
    sqlite3_stmt *st = h->stmt;
    int64_t v;
    for (int c = c0; c < 4; c++) {
        int type = sqlite3_column_type(st, c);
        if (c == 0 && type == SQLITE_TEXT) {
            const char *p = (const char *)sqlite3_column_text(st, 0);
            int64_t n_links = h->b->links.n;
            int64_t id = name_id(&h->b->links, p, sqlite3_column_bytes(st, 0), 1);
            if (id < 0 || (id == n_links && add_link(h, id))) return SQLITE_NOMEM;
            h->r_lid = (int32_t)id;
        } else if (c == 1 && (type == SQLITE_FLOAT || type == SQLITE_INTEGER)) {
            h->r_ts = sqlite3_column_double(st, 1);
        } else if (c == 2 && type == SQLITE_INTEGER
                   && (v = sqlite3_column_int64(st, 2)) >= -128 && v <= 127) {
            h->r_state = (int8_t)v;
        } else if (c == 3 && type == SQLITE_INTEGER) {
            h->r_crc = sqlite3_column_int64(st, 3);
        } else {
            h->bad_col = c;
            h->bad = column_value(st, c);
            return TPUD_VALUE;
        }
    }
    return put(h);
}

/* One row of the walk: SQLITE_OK where one was read, SQLITE_DONE at the
 * end (the DB still open), else where the walk stops. */
static int step(tpud_reader *h) {
    int rc = sqlite3_step(h->stmt);
    if (rc == SQLITE_DONE) return rc;
    if (rc != SQLITE_ROW) return fail(h, rc);
    h->n_rows++;
    return fill(h, 0);
}

static int walk(tpud_reader *h) {
    int rc;
    while ((rc = step(h)) == SQLITE_OK) {
    }
    return rc;
}

/* A walk's code once it ended: the DB and its floors let go, at the host's
 * last DB the block closed too. */
static int end_walk(tpud_reader *h, int rc) {
    if (rc != SQLITE_DONE) return rc;
    finish(h);
    /* the floors served this walk alone */
    free_names(&h->floors);
    h->floors = (name_table){0};
    free(h->floor_of);
    h->floor_of = NULL;
    return h->owns ? close_block(h) : rc;
}

static int start_walk(tpud_reader *h, const char *sql, double start) {
    int rc = sqlite3_prepare_v2(h->db, sql, -1, &h->stmt, NULL);
    if (rc != SQLITE_OK) return fail(h, rc);
    if ((rc = sqlite3_bind_double(h->stmt, 1, start)) != SQLITE_OK) return fail(h, rc);
    return SQLITE_OK;
}

/* A walk to its end on the calling thread: the links already in the block
 * (a host's DB after its first) take this DB's floors first. */
static int walk_here(tpud_reader *h, const char *sql, double start) {
    int rc = start_walk(h, sql, start);
    for (int64_t k = 0; rc == SQLITE_OK && k < h->b->links.n; k++) rc = link_floor(h, k);
    return end_walk(h, rc ? rc : walk(h));
}

/* Stores the caller's conversion of the value that stopped the walk (f for
 * ts, i for state and CRC) and walks on. */
int tpud_resume(tpud_reader *h, double f, int64_t i) {
    if (h->bad_col == 1) h->r_ts = f;
    else if (h->bad_col == 2) h->r_state = (int8_t)i;
    else h->r_crc = i;
    int rc = fill(h, (int)h->bad_col + 1);
    return end_walk(h, rc ? rc : walk(h));
}

static void free_block(tpud_block *b) {
    if (!b) return;
    free_names(&b->links);
    for (int64_t k = 0; b->raw && k < b->links_cap; k++) free(b->raw[k]);
    free(b->raw);
    free(b->kept);
    free(b->base);
    free(b->floor);
    tpud_unmap(b->buf, b->bytes);
    free(b);
}

void tpud_close(tpud_reader *h) {
    if (!h) return;
    finish(h);
    free(h->errmsg);
    free_values(h->tombstones, 2 * h->n_tombstones);
    free_names(&h->floors);
    free(h->floor_of);
    if (h->owns) free_block(h->b);
    free(h);
}

/* Whether this side judges the tombstones as the loader would: the read
 * succeeded, or failed with SQLITE_ERROR (Python's OperationalError, taken
 * as no tombstones), and no row with a TEXT name holds a name that is not
 * ASCII (its UTF-8 decode may fail) or a ts that is no number. */
static int judges(const tpud_reader *h) {
    if (h->tomb_rc) return h->tomb_rc == SQLITE_ERROR;
    for (int64_t k = 0; k < h->n_tombstones; k++) {
        const tpud_value *name = &h->tombstones[2 * k], *ts = &name[1];
        if (name->type != SQLITE_TEXT) continue; /* matches no TEXT name */
        for (int64_t b = 0; b < name->n; b++) {
            if ((unsigned char)name->p[b] >= 0x80) return 0;
        }
        if (ts->type != SQLITE_INTEGER && ts->type != SQLITE_FLOAT) return 0;
    }
    return 1;
}

/* The floors from n (link, ts) rows, each ts a number where the link is
 * TEXT (other names match no link), as the loader computes them from a dict
 * of the rows: a link's floor is the larger of the "*" row's ts and its own
 * row's (the last row where a name repeats); a link without a row takes the
 * larger of the "*" row's and 0. */
static int set_floors(tpud_reader *h, const tpud_value *rows, int64_t n) {
    double g = 0.0;
    for (int64_t k = 0; k < n; k++) {
        const tpud_value *name = &rows[2 * k], *ts = &name[1];
        if (name->type == SQLITE_TEXT && name->n == 1 && name->p[0] == '*')
            g = ts->type == SQLITE_INTEGER ? ts->i : ts->f;
    }
    h->floor0 = 0.0 > g ? 0.0 : g;
    if (n && !(h->floor_of = malloc(n * sizeof *h->floor_of))) return SQLITE_NOMEM;
    for (int64_t k = 0; k < n; k++) {
        const tpud_value *name = &rows[2 * k], *ts = &name[1];
        if (name->type != SQLITE_TEXT) continue;
        int64_t id = name_id(&h->floors, name->p, name->n, 1);
        if (id < 0) return SQLITE_NOMEM;
        double v = ts->type == SQLITE_INTEGER ? ts->i : ts->f;
        h->floor_of[id] = v > g ? v : g;
    }
    return SQLITE_OK;
}

/* The walk of a DB whose tombstones the caller judged, to its end:
 * `rows`, as set_floors takes them, give the floors. */
int tpud_walk(tpud_reader *h, const char *sql, double start, const tpud_value *rows,
              int64_t n) {
    if (set_floors(h, rows, n)) return SQLITE_NOMEM;
    return walk_here(h, sql, start);
}

static double clock_s(clockid_t c) {
    struct timespec t;
    clock_gettime(c, &t);
    return t.tv_sec + t.tv_nsec * 1e-9;
}

/* One DB's read, as the loader asks for it. */
typedef struct tpud_job {
    /* the caller's */
    const char *uri;
    const char *tombstone_sql;
    const char *sql;
    double start;
    int64_t max_samples;    /* at least 1 */
    int64_t first;          /* the host's first DB, whose job keeps the host's block */
    int64_t last;           /* the host's last DB */
    /* the read's */
    tpud_block *b;          /* a host's first DB: the block, till its last DB is taken */
    tpud_reader *h;
    int64_t opened;         /* else rc is the open's failure */
    int64_t rc;             /* the open's or the walk's code; TPUD_FLOORS */
    double open_s;          /* the open, its tombstones and their floors, the block made */
    double fetch_s;         /* the walk, the DB's close and the block's */
    double cpu_s;           /* the read's thread CPU */
    double wait_s;          /* the taking thread's wait for the job's worker */
    int64_t on_worker;      /* the read ran on a worker thread */
} tpud_job;

/* A host's block, first sized for `links` links of `t` samples. */
static int new_block(tpud_reader *h, int64_t max_samples, int64_t links, int64_t t) {
    tpud_block *b = h->b = calloc(1, sizeof *b);
    if (!b) return SQLITE_NOMEM;
    b->max_samples = max_samples;
    b->t_cap = t < max_samples ? t : max_samples;
    if (reserve_names(&b->links, links, 32 * links) || reserve_links(h, links))
        return SQLITE_NOMEM;
    return SQLITE_OK;
}

/* A block just closed: the next blocks' first size, where it is the largest. */
static void size_hint(tpud_pool *p, const tpud_block *b) {
    pthread_mutex_lock(&p->mu);
    if (b->links.n > p->links_hint) p->links_hint = b->links.n;
    if (b->t > p->t_hint) p->t_hint = b->t;
    pthread_mutex_unlock(&p->mu);
}

/* Reads job i on the calling thread: opens its DB and judges its floors. A
 * host's first DB gets the host's block, first sized as the largest closed
 * before it, and where its floors are judged here it is walked to the end,
 * the DB closed, and at the host's last DB the block closed too. A DB after
 * its host's first continues a block that a DB before it writes: it is
 * walked when taken. */
static void read_job(tpud_pool *p, int64_t i) {
    tpud_job *j = &p->jobs[i];
    double w0 = clock_s(CLOCK_MONOTONIC), c0 = clock_s(CLOCK_THREAD_CPUTIME_ID);
    int rc = tpud_open(j->uri, j->tombstone_sql, &j->h);
    tpud_reader *h = j->h;
    j->opened = rc == SQLITE_OK;
    if (rc == SQLITE_OK)
        rc = !judges(h) ? TPUD_FLOORS : set_floors(h, h->tombstones, h->tomb_rc ? 0 : h->n_tombstones);
    int walks = j->opened && j->first == i;
    if (walks && (rc == SQLITE_OK || rc == TPUD_FLOORS)) {
        pthread_mutex_lock(&p->mu);
        int64_t links = p->links_hint ? p->links_hint : 256, t = p->t_hint ? p->t_hint : 64;
        pthread_mutex_unlock(&p->mu);
        int made = new_block(h, j->max_samples, links, t);
        /* the block is the host's last DB's reader's; till then this job's */
        if (j->last) h->owns = 1;
        else j->b = h->b;
        if (made != SQLITE_OK) rc = made;
        else if (rc == SQLITE_OK) rc = start_walk(h, j->sql, j->start);
    }
    double w1 = clock_s(CLOCK_MONOTONIC);
    j->open_s = w1 - w0;
    if (walks && rc == SQLITE_OK) {
        rc = end_walk(h, walk(h));
        if (rc == SQLITE_DONE && h->owns) size_hint(p, h->b);
        j->fetch_s = clock_s(CLOCK_MONOTONIC) - w1;
    }
    j->rc = rc;
    j->cpu_s = clock_s(CLOCK_THREAD_CPUTIME_ID) - c0;
}

static void *work(void *arg) {
    tpud_pool *p = arg;
    pthread_mutex_lock(&p->mu);
    for (;;) {
        while (!p->stop && p->next < p->n && p->next >= p->taken + p->window)
            pthread_cond_wait(&p->cv, &p->mu);
        if (p->stop || p->next >= p->n) break;
        int64_t i = p->next++;
        pthread_mutex_unlock(&p->mu);
        p->jobs[i].on_worker = 1;
        read_job(p, i);
        pthread_mutex_lock(&p->mu);
        p->done[i] = 1;
        pthread_cond_broadcast(&p->cv);
    }
    pthread_mutex_unlock(&p->mu);
    return NULL;
}

static void free_pool(tpud_pool *p) {
    pthread_mutex_destroy(&p->mu);
    pthread_cond_destroy(&p->cv);
    free(p->done);
    free(p->threads);
    free(p);
}

/* A pool over jobs[0..n): with `workers` of 2 or more, as many threads of
 * stack_bytes stacks (larger where that is refused) read the jobs in order,
 * at most `workers` ahead of the last one taken; else tpud_pool_take reads
 * each job. NULL out of memory. */
tpud_pool *tpud_pool_start(tpud_job *jobs, int64_t n, int64_t workers, int64_t stack_bytes) {
    tpud_pool *p = calloc(1, sizeof *p);
    if (!p) return NULL;
    p->jobs = jobs;
    p->n = n;
    p->window = workers;
    p->done = calloc(n ? n : 1, 1);
    p->threads = calloc(workers > 1 ? workers : 1, sizeof *p->threads);
    pthread_mutex_init(&p->mu, NULL);
    pthread_cond_init(&p->cv, NULL);
    if (!p->done || !p->threads) {
        free_pool(p);
        return NULL;
    }
    pthread_attr_t a;
    pthread_attr_init(&a);
    for (int64_t k = 0; workers > 1 && k < workers; k++) {
        /* a stack also holds the thread's static TLS: a size too small for
         * it is refused, and a larger one tried */
        int rc = EINVAL;
        for (int64_t size = stack_bytes; rc == EINVAL && size <= 64 * stack_bytes; size *= 4) {
            if (pthread_attr_setstacksize(&a, size) == 0)
                rc = pthread_create(&p->threads[k], &a, work, p);
        }
        if (rc) break; /* fewer threads, or none: the taking thread reads */
        pthread_setname_np(p->threads[k], "fleet_scan-read");
        p->n_threads++;
    }
    pthread_attr_destroy(&a);
    return p;
}

int64_t tpud_pool_threads(tpud_pool *p) {
    return p->n_threads;
}

/* Job i, the one after the last taken, once read; a DB after its host's
 * first is walked here. Its handle is the caller's from here, and at the
 * host's last DB the host's block with it. */
void tpud_pool_take(tpud_pool *p, int64_t i) {
    tpud_job *j = &p->jobs[i];
    if (!p->n_threads) {
        read_job(p, i);
        p->done[i] = 1;
    }
    double w0 = clock_s(CLOCK_MONOTONIC);
    pthread_mutex_lock(&p->mu);
    while (!p->done[i]) pthread_cond_wait(&p->cv, &p->mu);
    p->taken = i + 1;
    pthread_cond_broadcast(&p->cv);
    pthread_mutex_unlock(&p->mu);
    j->wait_s = p->n_threads ? clock_s(CLOCK_MONOTONIC) - w0 : 0.0;
    tpud_reader *h = j->h;
    if (!j->opened || j->first == i) return;
    tpud_job *f = &p->jobs[j->first];
    h->b = f->b;
    if (j->last) {
        h->owns = 1;
        f->b = NULL;
    }
    if (j->rc == SQLITE_OK) {
        double e0 = clock_s(CLOCK_MONOTONIC), c0 = clock_s(CLOCK_THREAD_CPUTIME_ID);
        j->rc = walk_here(h, j->sql, j->start);
        if (j->rc == SQLITE_DONE && h->owns) size_hint(p, h->b);
        j->fetch_s += clock_s(CLOCK_MONOTONIC) - e0;
        j->cpu_s += clock_s(CLOCK_THREAD_CPUTIME_ID) - c0;
    }
}

/* Starts no more reads, waits for the workers to end theirs, and closes the
 * handles of the jobs not taken and the blocks of the hosts whose last DB
 * was not taken. */
void tpud_pool_stop(tpud_pool *p) {
    pthread_mutex_lock(&p->mu);
    p->stop = 1;
    pthread_cond_broadcast(&p->cv);
    pthread_mutex_unlock(&p->mu);
    for (int64_t k = 0; k < p->n_threads; k++) pthread_join(p->threads[k], NULL);
    for (int64_t i = 0; i < p->n; i++) {
        if (i >= p->taken) {
            tpud_close(p->jobs[i].h);
            p->jobs[i].h = NULL;
        }
        free_block(p->jobs[i].b);
        p->jobs[i].b = NULL;
    }
    free_pool(p);
}
